"""Gradient exchange over the worker axis (``ewdml_tpu/parallel/collectives.py``).

Semantics are the PS-faithful ones of the JAX package: each worker
compresses its full local gradient, the payloads are exchanged, and the
W payloads are decompressed and averaged; the optional relay requantizes
the average with a key shared by all ranks (the server's compressed
broadcast of Methods 4/5). Gradients are per-worker lists of leaves, in the
JAX tree's leaf order and element layout (``models/convert.py``).

Transports, with the JAX package's math:

- ``all_gather`` (default): one gather of the payloads, local
  decompress-and-average.
- ``ppermute`` (``--gather-type ring``): W - 1 ring hops of the payloads,
  each arrival decompressed into a per-origin slot.
- ``ring_rs`` (``--gather-type ring_rs``): ring reduce-scatter with a
  requantization per hop, then a ring all-gather of the owned mean chunks;
  an int8 blockwise QSGD wire runs its hops through the fused
  ``chunk_encode``/``dequant_acc_requant`` kernels.
- ``fused_q_allreduce_mean`` (``--collective fused_q``): the dense
  exchange as an int8-wire ring over one flat buffer, on the same kernels.

The ring hops of phase 1 differ per rank and all run. Where every rank
would decode the same bytes (the average of the gather and ring
transports, a ring's phase 2), the result is computed once per process
and handed to each of its workers: every origin's payload is decoded once,
from this process's own values where it holds the origin, else from what
arrived over the ring (on a :class:`LocalWorld` every origin is local, so
nothing that arrives is decoded; on a
:class:`~ewdml_tpu_torch.core.world.ProcessWorld` the hops carry the other
processes' payloads here). The hops always run, as they move (and
``ppermute_bytes`` counts) the bytes a real ring ships. Only the per-rank
"own payload" of error feedback differs between ranks. The per-worker
lists hold this process's workers, indexed by the local j; keys and chunk
ids fold the global rank ``world.ranks[j]``.

On a two-level world (``--num-slices S``),
:func:`hierarchical_compressed_allreduce` runs the compressed exchange
within each slice (ICI), then once more over the slices' averages (DCN).
"""

from __future__ import annotations

import torch

from ewdml_tpu_torch.core.world import LocalWorld, ProcessWorld
from ewdml_tpu_torch.ops import kernels, packing
from ewdml_tpu_torch.ops import qsgd as qsgd_mod
from ewdml_tpu_torch.ops.blocktopk import BlockTopKQSGDPayload
from ewdml_tpu_torch.ops.bytes import take_payloads, unstack_payload
from ewdml_tpu_torch.ops.chain import TopKQSGDCompressor, TopKQSGDPayload
from ewdml_tpu_torch.ops.topk import TopKPayload, top_k_indices
from ewdml_tpu_torch.utils import prng


def dense_allreduce_mean(world: LocalWorld, grads: list,
                         wire_dtype=None) -> list:
    """Method 1/3 dense path: one pmean per leaf. ``grads[j]`` is the
    list of leaves of the world's j-th local worker (``world.ranks[j]``);
    returns the averaged leaves.

    ``wire_dtype=torch.bfloat16`` (``--precision-policy bf16_wire``,
    ``collectives.py:46-84``) halves the payload: each f32 leaf is gathered
    as bf16 (what crosses the wire) and the mean is taken in f32 over the
    upcast gather, so accumulation stays f32. A non-f32 leaf crosses
    untouched and its mean keeps its dtype. Under f32 the path is the plain
    pmean."""
    n = len(grads[0])
    if wire_dtype is None or wire_dtype == torch.float32:
        return [world.pmean([g[i] for g in grads]) for i in range(n)]
    out = []
    for i in range(n):
        leaf = [g[i] for g in grads]
        dtype = leaf[0].dtype
        wire = [x.to(wire_dtype) for x in leaf] if dtype == torch.float32 \
            else leaf
        gathered = world.all_gather(wire).to(torch.float32)
        mean = gathered.sum(dim=0) / world.size
        out.append(mean if dtype == torch.float32 else mean.to(dtype))
    return out


def fused_chunk_elems(n: int, world: int, block: int) -> int:
    """Per-rank ring-chunk length of the fused quantized transports:
    ``ceil(n / world)`` rounded up to whole quantization blocks (the zero
    padding quantizes to zero levels and adds nothing to a block norm).
    Shared with the analytic wire plan (``train/metrics.wire_plan``)."""
    per_rank = -(-n // world)
    return -(-per_rank // block) * block


def _ring_chunks(flat: torch.Tensor, world: int, m: int) -> torch.Tensor:
    """``flat`` zero-padded to ``world * m`` and viewed as ``[world, m]``."""
    chunks = torch.zeros(world * m, dtype=torch.float32, device=flat.device)
    chunks[:flat.numel()] = flat
    return chunks.reshape(world, m)


def _ring_seed(key, tag: int, device) -> torch.Tensor:
    return prng.seed_tensor(prng.fold_in(key, tag), device)


def _fused_reduce_scatter(world: LocalWorld, chunks: list, keys: list,
                          s: int, block: int) -> list:
    """Phase 1 of the fused rings: rank r encodes its chunk r, then at hop h
    receives the running sum of chunk ``(r - h) % W`` and adds its own chunk
    ``(r - h - 1) % W`` in one ``dequant_acc_requant`` pass (seed tags 0,
    then h + 1; the last hop folds in the 1/W). Returns each rank's encoded
    mean of chunk ``(r + 1) % W`` as ``(levels, norms)``."""
    w = world.size
    encode, hop = kernels.ring_hops(world.device)
    pay = [encode(chunks[j][r], _ring_seed(keys[j], 0, world.device), s,
                  block=block)
           for j, r in enumerate(world.ranks)]
    for h in range(w - 1):
        pay = world.ppermute(pay)
        scale = 1.0 / w if h == w - 2 else 1.0
        pay = [hop(lv, nm, chunks[j][(r - h - 1) % w],
                   _ring_seed(keys[j], h + 1, world.device), s, block=block,
                   scale=scale)
               for j, (r, (lv, nm)) in enumerate(zip(world.ranks, pay))]
    return pay


def _ring_slots(world: LocalWorld, values: list) -> dict:
    """The W - 1 hops of a ring all-gather of ``values`` (this process's
    ranks'): at hop h rank r receives origin ``(r - h - 1) % W``'s value.
    Returns every origin's value, each taken once: this process's own,
    and for the other origins the first arrival."""
    w = world.size
    slots = {r: v for r, v in zip(world.ranks, values)}
    current = values
    for h in range(w - 1):
        current = world.ppermute(current)
        if len(slots) < w:
            for r, v in zip(world.ranks, current):
                slots.setdefault((r - h - 1) % w, v)
    return slots


def _ring_all_gather(world: LocalWorld, owned: list, decode, m: int):
    """Phase 2 of the rings: rank r owns chunk ``(r + 1) % W``, and every
    rank decodes every owner's payload from the same bytes, each owner's
    once (:func:`_ring_slots`). Returns the flat ``[W * m]`` result, the
    same on every rank."""
    w = world.size
    slots = _ring_slots(world, owned)
    out = torch.empty((w, m), dtype=torch.float32, device=world.device)
    for r in range(w):
        out[(r + 1) % w] = decode(slots[r]).reshape(-1)
    return out.reshape(-1)


def fused_q_allreduce_mean(world: LocalWorld, grads: list, key) -> list:
    """The dense exchange as an int8-wire ring (``--collective fused_q``,
    ``collectives.py:99``): the whole tree in one flat buffer, W chunks of
    whole 4096-element blocks, a ring reduce-scatter whose hops re-encode
    in one kernel pass each, then a ring all-gather of the encoded mean
    chunks. ``key`` is the step key, folded per rank. Returns the averaged
    leaves (the gradients untouched at W = 1)."""
    w = world.size
    if w == 1:
        return grads[0]
    s, block = 127, kernels.BLOCK_ELEMS
    parts = [fuse_tree(g) for g in grads]
    split = parts[0][1]
    n = parts[0][0].numel()
    m = fused_chunk_elems(n, w, block)
    chunks = [_ring_chunks(flat, w, m) for flat, _ in parts]
    keys = [prng.rank_key(key, r) for r in world.ranks]
    owned = _fused_reduce_scatter(world, chunks, keys, s, block)
    out = _ring_all_gather(
        world, owned, lambda p: kernels.decode_blocks(*p, s, block=block), m)
    return split(out[:n])


def fused_ring_eligible(compressor) -> bool:
    """Whether the ``ring_rs`` hops run as fused kernel passes
    (``collectives.py:579``): an unpacked int8 QSGD wire with L2 norms per
    block of a multiple of 4096 elements."""
    return (isinstance(compressor, qsgd_mod.QSGDCompressor)
            and compressor.quantum_num <= 127
            and packing.width_for(compressor.quantum_num) >= 8
            and compressor.norm_kind == "l2"
            and kernels.blockwise_supported(compressor.block))


def _ring_rs_exchange(world: LocalWorld, gs: list, compressor,
                      keys: list) -> torch.Tensor:
    """Compressed ring allreduce of one unit (``collectives.py:595``): ring
    reduce-scatter with a requantization per hop, then a ring all-gather
    of the compressed mean chunks. ``gs[j]``/``keys[j]`` are rank r's
    tensor and key, j the local index of global rank ``world.ranks[j]``.

    On an eligible wire (:func:`fused_ring_eligible`) phase 1 is the fused
    ring of :func:`fused_q_allreduce_mean`, in chunks of whole blocks, and
    the last hop's payload (the mean) is phase 2's. Otherwise each hop
    compresses and decompresses with ``fold_in(key, h)`` and the owned
    mean is compressed once more with ``fold_in(key, 0x46)``."""
    w = world.size
    n, shape = gs[0].numel(), tuple(gs[0].shape)
    fused = fused_ring_eligible(compressor)
    m = (fused_chunk_elems(n, w, compressor.block) if fused else -(-n // w))
    chunks = [_ring_chunks(g.to(torch.float32).reshape(-1), w, m) for g in gs]
    if fused:
        qs, blk = compressor.quantum_num, compressor.block
        owned = [qsgd_mod.QSGDPayload(levels=lv, norm=nm, shape=(m,), s=qs,
                                      block=blk)
                 for lv, nm in _fused_reduce_scatter(world, chunks, keys, qs,
                                                     blk)]
    else:
        send = [chunks[j][r] for j, r in enumerate(world.ranks)]
        for h in range(w - 1):
            received = world.ppermute(
                [compressor.compress(prng.fold_in(keys[j], h), send[j])
                 for j in range(len(send))])
            send = [chunks[j][(r - h - 1) % w]
                    + compressor.decompress(received[j])
                    for j, r in enumerate(world.ranks)]
        owned = [compressor.compress(prng.fold_in(keys[j], 0x46), send[j] / w)
                 for j in range(len(send))]
    out = _ring_all_gather(world, owned, compressor.decompress, m)
    return out[:n].reshape(shape)


def _ring_exchange(world: LocalWorld, payloads: list, compressor,
                   num_aggregate: int, step: int) -> torch.Tensor:
    """The ``ppermute`` transport (``collectives.py:686``): the payloads go
    W - 1 times round the ring, each origin's decompressed once into its
    slot (:func:`_ring_slots`), and the slots are summed in origin order
    (so every rank sums the same values in the same order). K-of-N
    acceptance weighs origins ``{(step + j) % W : j < K}`` by 1, the
    others by 0."""
    w = world.size
    k = num_aggregate if 0 < num_aggregate < w else w
    slots = _ring_slots(world, payloads)
    acc, total = None, 0.0
    for origin in range(w):
        weight = 1.0 if k >= w or (origin - step) % w < k else 0.0
        slot = weight * compressor.decompress(slots[origin])
        acc = slot if acc is None else acc + slot
        total += weight
    return acc / total


def fuse_tree(leaves: list):
    """All leaves as one flat f32 vector; returns ``(flat, split)``."""
    sizes = [l.numel() for l in leaves]
    shapes = [tuple(l.shape) for l in leaves]
    flat = torch.cat([l.to(torch.float32).reshape(-1) for l in leaves])

    def split(v):
        out, off = [], 0
        for size, shape in zip(sizes, shapes):
            out.append(v[off:off + size].reshape(shape))
            off += size
        return out

    return flat, split


def bucket_groups(sizes, bucket_bytes: int):
    """Greedy leaf-order grouping into ~bucket_bytes f32 buckets; a leaf
    larger than the threshold gets its own bucket (``collectives.py:196``)."""
    groups, cur, cur_b = [], [], 0
    for i, size in enumerate(sizes):
        nb = size * 4
        if cur and cur_b + nb > bucket_bytes:
            groups.append(cur)
            cur, cur_b = [], 0
        cur.append(i)
        cur_b += nb
    if cur:
        groups.append(cur)
    return groups


def bucket_tree(leaves: list, bucket_bytes: int):
    """Pack leaves in order into ~bucket_bytes flat f32 buckets; returns
    ``(buckets, unsplit)``."""
    sizes = [l.numel() for l in leaves]
    shapes = [tuple(l.shape) for l in leaves]
    groups = bucket_groups(sizes, bucket_bytes)
    buckets = [torch.cat([leaves[i].to(torch.float32).reshape(-1) for i in g])
               for g in groups]

    def unsplit(bucket_vals):
        out = [None] * len(leaves)
        for g, v in zip(groups, bucket_vals):
            off = 0
            for i in g:
                out[i] = v[off:off + sizes[i]].reshape(shapes[i])
                off += sizes[i]
        return out

    return buckets, unsplit


def _fusion_units(grads: list, fuse: bool, bucket_bytes):
    """Each worker's leaves as its transport units (one flat bucket under
    ``fuse``, ~``bucket_bytes`` buckets otherwise), and ``unfuse(result,
    with_own)``, which splits an exchange's result over those units (and
    each worker's own view, ``with_own``) back into leaves."""
    parts = [fuse_tree(g) if fuse else bucket_tree(g, bucket_bytes)
             for g in grads]
    units = [[p[0]] if fuse else p[0] for p in parts]
    unsplit = parts[0][1]  # the same leaf shapes on every worker

    def split(vals):
        return unsplit(vals[0]) if fuse else unsplit(vals)

    def unfuse(result, with_own: bool):
        if with_own:
            avg, own = result
            return split(avg), [split(o) for o in own]
        return split(result)

    return units, unfuse


def _accept_rotating(gathered, num_aggregate: int, world: int, step: int):
    """K-of-N acceptance: keep origins ``{(step + j) % W : j < K}``, in that
    order. Returns ``(gathered', k_accepted)``."""
    k = num_aggregate if 0 < num_aggregate < world else world
    if k < world:
        gathered = take_payloads(gathered, [(step + j) % world for j in range(k)])
    return gathered, k


def _mean_of_decompressed(gathered, compressor, num_aggregate: int,
                          world: int, step: int = 0):
    """Decompress the gathered payloads and average (K-of-N aware); QSGD
    payloads go through the fused ``dequant_mean`` kernel."""
    gathered, k_acc = _accept_rotating(gathered, num_aggregate, world, step)
    impl = None
    if isinstance(gathered, qsgd_mod.QSGDPayload):
        # Gated on the total work (W x n): one launch covers all payloads.
        impl = kernels.active_for(gathered.levels.numel(),
                                  gathered.levels.device)
    if (impl is not None and not gathered.packed and gathered.s <= 127
            and (gathered.block is None
                 or kernels.blockwise_supported(gathered.block))):
        mean = kernels.dequant_mean if impl == "kernel" else kernels.dequant_mean_ref
        flat = mean(gathered.levels, gathered.norm, gathered.s,
                    block=gathered.block)
        return flat.reshape(gathered.shape)
    dec = torch.stack([compressor.decompress(unstack_payload(gathered, w))
                       for w in range(k_acc)])
    return dec.mean(dim=0)


def _sparse_mean(gathered, num_aggregate: int, world: int, step: int):
    """Combine the gathered (indices, values) pairs with one dense
    scatter-add. Returns ``(avg_flat [n], cand_idx [k_acc * k])``."""
    from ewdml_tpu_torch.ops.chain import dequant_values

    gathered, k_acc = _accept_rotating(gathered, num_aggregate, world, step)
    if isinstance(gathered, TopKQSGDPayload):
        vals = torch.stack([dequant_values(unstack_payload(gathered, w))
                            for w in range(k_acc)])
    else:
        vals = gathered.values
    cand = gathered.indices.reshape(-1)
    dense = torch.zeros(gathered.numel, dtype=torch.float32, device=cand.device)
    dense.index_add_(0, cand.long(), vals.reshape(-1).to(torch.float32))
    return dense / k_acc, cand


def _block_mean_relay(gathered, num_aggregate: int, world: int, step: int,
                      relay: bool, compressor, rk):
    """Aggregation + optional relay for block-top-k payloads: every worker's
    winner for column c lives in column c (``collectives.py:318``)."""
    from ewdml_tpu_torch.ops import blocktopk

    gathered, k_acc = _accept_rotating(gathered, num_aggregate, world, step)
    vals = torch.stack([blocktopk.dequant_values(unstack_payload(gathered, w))
                        for w in range(k_acc)])            # (W', nb)
    locs = gathered.locs.to(torch.int32)                  # (W', nb)
    nb, blk_pad = gathered.nb, gathered.blk_pad
    numel, shape = gathered.numel, gathered.shape
    w_acc = vals.shape[0]
    if not relay:
        rows = torch.arange(blk_pad, dtype=torch.int32, device=vals.device)[:, None]
        dense = torch.zeros((blk_pad, nb), dtype=torch.float32, device=vals.device)
        zero = torch.zeros((), dtype=torch.float32, device=vals.device)
        for w in range(w_acc):
            dense = dense + torch.where(rows == locs[w][None, :],
                                        vals[w][None, :], zero)
        avg2 = dense / k_acc
        return avg2.reshape(-1)[:numel].reshape(shape)
    if w_acc == 1:
        new_locs, new_vals = locs[0], vals[0] / k_acc
    else:
        eq = locs[:, None, :] == locs[None, :, :]
        cand = torch.where(eq, vals[None, :, :],
                           torch.zeros((), dtype=vals.dtype,
                                       device=vals.device)).sum(dim=1) / k_acc
        w_star = torch.argmax(cand.abs(), dim=0)          # first max
        new_locs = locs.gather(0, w_star[None, :])[0]
        new_vals = cand.gather(0, w_star[None, :])[0]
    if isinstance(compressor, TopKQSGDCompressor):
        q = qsgd_mod.compress(rk, new_vals, compressor.quantum_num,
                              block=compressor.block)
        new_vals = qsgd_mod.decompress(q)
    return blocktopk.expand(new_vals, new_locs, nb, blk_pad, numel, shape)


def _sparse_relay(avg_flat, cand_idx, k: int, compressor, rk, world: int = 0):
    """The server's re-compression of the average over its candidate
    support only (``collectives.py:387``): dedup the candidates, exact top-k
    among them, quantize the winners."""
    cand_idx = cand_idx.long()
    cand_vals = avg_flat[cand_idx]
    if world == 1 and cand_idx.numel() == k:
        sel_idx, sel_vals = cand_idx, cand_vals
    else:
        order = torch.argsort(cand_idx, stable=True)
        sorted_idx = cand_idx[order]
        first = torch.cat([torch.ones(1, dtype=torch.bool, device=cand_idx.device),
                           sorted_idx[1:] != sorted_idx[:-1]])
        uniq = torch.zeros(cand_idx.shape, dtype=torch.bool,
                           device=cand_idx.device)
        uniq[order] = first
        mag = torch.where(uniq, cand_vals.abs(),
                          torch.full_like(cand_vals, -1.0))
        pos = top_k_indices(mag, k)
        sel_idx = cand_idx[pos]
        sel_vals = cand_vals[pos]
    if isinstance(compressor, TopKQSGDCompressor):
        q = qsgd_mod.compress(rk, sel_vals, compressor.quantum_num,
                              block=compressor.block)
        sel_vals = qsgd_mod.decompress(q)
    out = torch.zeros_like(avg_flat)
    out[sel_idx] = sel_vals
    return out


def compressed_allreduce(world: LocalWorld, grads: list, compressor, key,
                         num_aggregate: int = 0, relay: bool = False,
                         relay_key=None, transport: str = "all_gather",
                         return_own_decompressed: bool = False,
                         step: int = 0, fuse: bool = False,
                         bucket_bytes: int | None = None):
    """Compress -> exchange -> decompress-average each leaf (``collectives.py:433``).

    ``grads[j]`` is the list of leaves of the world's j-th local worker,
    global rank ``world.ranks[j]``. ``key`` is the step key; it is folded
    per (global rank, leaf) as in the JAX package. ``transport`` is
    ``all_gather``, ``ppermute`` or ``ring_rs``. Returns the averaged
    leaves (shared by all workers), and with ``return_own_decompressed``
    also each worker's own decompressed payload (for error feedback)."""
    if fuse and bucket_bytes:
        raise ValueError("fuse and bucket_bytes are mutually exclusive")
    if (fuse or bucket_bytes) and hasattr(compressor, "for_leaf"):
        raise ValueError(
            "per-unit compression plans (ewdml_tpu/adapt) require per-layer "
            "transport units; fusion would merge leaves with different "
            "decisions into one payload (--fusion none)")
    if fuse or bucket_bytes:
        units, unfuse = _fusion_units(grads, fuse, bucket_bytes)
        return unfuse(compressed_allreduce(
            world, units, compressor, key, num_aggregate=num_aggregate,
            relay=relay, relay_key=relay_key, transport=transport,
            return_own_decompressed=return_own_decompressed, step=step),
            return_own_decompressed)

    if transport == "ring_rs" and return_own_decompressed:
        raise ValueError(
            "ring_rs transport does not support error feedback (partial sums "
            "are requantized per hop, so no per-rank 'own payload' exists); "
            "use the all_gather transport")
    w_n = world.size
    if transport == "ring_rs" and 0 < num_aggregate < w_n:
        raise ValueError(
            "ring_rs transport does not support K-of-N acceptance; use the "
            "all_gather transport")
    rkeys = [prng.rank_key(key, r) for r in world.ranks]
    local = range(len(rkeys))
    out, own = [], [[] for _ in local]
    per_unit = hasattr(compressor, "for_leaf")
    for i in range(len(grads[0])):
        # A per-unit plan (adapt/) dispatches per leaf: ``for_leaf(i)`` is
        # unit i's sub-compressor.
        comp = compressor.for_leaf(i) if per_unit else compressor
        rk = (prng.layer_key(relay_key if relay_key is not None else key, i)
              if relay else None)
        if transport == "ring_rs":
            avg = _ring_rs_exchange(
                world, [g[i] for g in grads], comp,
                [prng.layer_key(rkeys[j], i) for j in local])
            if relay:
                avg = comp.decompress(comp.compress(rk, avg))
            out.append(avg)
            continue
        payloads = [comp.compress(prng.layer_key(rkeys[j], i), grads[j][i])
                    for j in local]
        if return_own_decompressed:
            for j in local:
                own[j].append(comp.decompress(payloads[j]))
        if transport == "ppermute":
            avg = _ring_exchange(world, payloads, comp, num_aggregate,
                                 step)
            if relay:
                avg = comp.decompress(comp.compress(rk, avg))
            out.append(avg)
            continue
        gathered = world.all_gather(payloads)
        payload = payloads[0]
        if isinstance(payload, BlockTopKQSGDPayload):
            avg = _block_mean_relay(gathered, num_aggregate, w_n, step, relay,
                                    comp, rk)
            out.append(avg.reshape(payload.shape))
            continue
        sparse = (isinstance(payload, (TopKPayload, TopKQSGDPayload))
                  and payload.indices.numel() * w_n < payload.numel)
        if sparse:
            avg_flat, cand_idx = _sparse_mean(gathered, num_aggregate, w_n, step)
            if relay:
                avg_flat = _sparse_relay(avg_flat, cand_idx,
                                         payload.indices.numel(), comp,
                                         rk, world=w_n)
            out.append(avg_flat.reshape(payload.shape))
            continue
        avg = _mean_of_decompressed(gathered, comp, num_aggregate, w_n,
                                    step)
        if relay:
            avg = comp.decompress(comp.compress(rk, avg))
        out.append(avg)
    if return_own_decompressed:
        return out, own
    return out


#: The DCN stage's fold of the step key (``collectives.py:767``).
DCN_TAG = 0xDC4


def hierarchical_compressed_allreduce(world: LocalWorld, grads: list,
                                      compressor, key, relay: bool = False,
                                      relay_key=None, fuse: bool = False,
                                      bucket_bytes: int | None = None,
                                      return_own_decompressed: bool = False):
    """The two-level exchange of a multi-slice world (``collectives.py:720``):
    :func:`compressed_allreduce` within each slice under the step ``key``
    (the ICI stage, no relay), then over the S slice averages under
    ``fold_in(key, 0xDC4)`` (the DCN stage, with the relay).

    ``grads[j]`` is the leaves of the world's j-th local worker, ranks
    linear over the slices. ``fuse`` and ``bucket_bytes`` split the tree
    once, around both levels. The ICI stage runs over the slices this
    process holds workers of (all of them on a :class:`LocalWorld`). A
    slice's average is the same on each of its workers, so every DCN
    column exchanges the same S values under the same keys: the stage is
    computed once, over the column of this process's first worker (column
    0 on a :class:`LocalWorld`, the only DCN sub-world the path builds),
    and its result handed to all of its columns. In a
    :class:`~ewdml_tpu_torch.core.world.ProcessWorld` each process
    contributes the averages of the slices it holds, at their slice
    index's key.

    With ``return_own_decompressed`` also returns each worker's effective
    transmitted view across both stages, ``own_ici + own_dcn - within``,
    so the residual ``g - own_eff`` is its ICI error plus its slice's DCN
    error (the same DCN term on every worker of a slice)."""
    if fuse or bucket_bytes:
        units, unfuse = _fusion_units(grads, fuse, bucket_bytes)
        return unfuse(hierarchical_compressed_allreduce(
            world, units, compressor, key, relay=relay, relay_key=relay_key,
            return_own_decompressed=return_own_decompressed),
            return_own_decompressed)
    base = world.ranks[0]
    slices = list(world.slices)
    within, own_ici = [], []
    for s in slices:
        ici = world.ici(s)
        res = compressed_allreduce(
            ici, [grads[r - base] for r in ici.local_members], compressor,
            key, return_own_decompressed=return_own_decompressed)
        if return_own_decompressed:
            res, own = res
            own_ici.extend(own)
        within.append(res)
    res = compressed_allreduce(
        world.dcn(world.coords(base)[1]), within, compressor,
        prng.fold_in(key, DCN_TAG), relay=relay, relay_key=relay_key,
        return_own_decompressed=return_own_decompressed)
    if not return_own_decompressed:
        return res
    across, own_dcn = res
    own_eff = []
    for j, r in enumerate(world.ranks):
        s = slices.index(world.coords(r)[0])
        own_eff.append([a + b - w for a, b, w in
                        zip(own_ici[j], own_dcn[s], within[s])])
    return across, own_eff


def adopt_best_worker(params: list, losses: torch.Tensor,
                      world=None) -> list:
    """Method 6 adoption (``collectives.py:786``): every worker takes the
    params of the worker with the lowest local loss (the first on ties).
    ``params[j]`` is the j-th local worker's list of tensors; ``losses``
    is ``[W]``, every worker's.

    The choice stays on the device (no read of the losses by the host,
    which a CUDA graph could not hold): each leaf is stacked over the
    workers and the best row selected. In a
    :class:`~ewdml_tpu_torch.core.world.ProcessWorld` the stacks are every
    worker's leaves, gathered as raw bytes (not counted as exchange
    bytes), so the selected bytes are those a :class:`LocalWorld` gives.
    Returns new tensors."""
    best = torch.argmin(losses).reshape(1)
    stacks = [torch.stack(list(leaf)) for leaf in zip(*params)]
    if isinstance(world, ProcessWorld):
        stacks = world.gather_rows_of(stacks)
    return [g.index_select(0, best)[0] for g in stacks]
