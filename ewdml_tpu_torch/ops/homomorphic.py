"""Compressed-domain server aggregation: the shared-scale contract
(``ewdml_tpu/ops/homomorphic.py``).

With one scale contract shared by every worker, quantized gradients sum
exactly in the integer domain (THC, PAPERS.md): the server adds K workers'
int8 levels in an int32 accumulator and dequantizes once per round, instead
of decoding every payload to f32 first.

- :func:`derive_contract`: the per-leaf (per-block) scales, derived
  deterministically from a template gradient both endpoints hold (the warm
  gradient of ``parallel/ps.run_async_ps``).
- :class:`HomomorphicCompressor`: per-leaf shared-scale twins of the
  config's QSGD-family compressor, dispatched through ``for_leaf(i)``.
- :func:`homomorphic_mean`: the server apply's core; per leaf one integer
  accumulate over the K payloads (``ops/kernels.int_accumulate`` on the
  card) into one arena, then every leaf's dequantize in one decode set
  (``ops/kernels.DecodeSet``, packed once a contract and divisor).

The aggregation tree's half (``--agg-tree``, ``parallel/aggtree.py``): a
mid-tier aggregator sums its subtree's int8 levels exactly and forwards one
int16 pseudo-push, so the hop's budget is ``weight x s <= INT16_WIRE_MAX``
(:func:`max_subtree_weight`, :func:`check_tier_budget`) beside the root's
int32 ``qsgd.check_sum_budget``; the root registers the int16 twin of the
payload schema (:func:`widen_payload_tree`) and divides by the total leaf
weight (``homomorphic_mean(..., k=)``).
"""

from __future__ import annotations

import weakref
import zlib
from typing import Optional

import numpy as np
import torch

from ewdml_tpu_torch.ops import chain, kernels, none, qsgd
from ewdml_tpu_torch.ops.bytes import numel

#: Default headroom of the scale contract: gradients up to this multiple of
#: the template's block norms encode without clipping.
DEFAULT_HEADROOM = 2.0


def _leaf_shared(sub, g_template: torch.Tensor, headroom: float):
    """The shared-scale twin of one leaf's sub-compressor (dense units pass
    through: f32 payloads already sum without a decode)."""
    if isinstance(sub, none.NoneCompressor):
        return sub
    if isinstance(sub, qsgd.QSGDCompressor):
        if sub.norm_kind != "l2":
            raise ValueError(
                "--server-agg homomorphic supports L2-scaled QSGD only "
                f"(got norm_kind={sub.norm_kind!r}; the TernGrad linf grid "
                "has no shared-scale contract here)")
        scales = qsgd.shared_scales(g_template, sub.quantum_num, sub.block,
                                    headroom)
        return qsgd.SharedScaleQSGD(scales, sub.quantum_num, sub.block)
    if isinstance(sub, chain.TopKQSGDCompressor):
        scales = qsgd.shared_scales(g_template, sub.quantum_num, sub.block,
                                    headroom)
        return chain.SharedScaleTopKQSGD(scales, sub.compress_ratio,
                                         sub.quantum_num, sub.exact,
                                         sub.block)
    raise TypeError(
        f"--server-agg homomorphic needs a QSGD-family compressor "
        f"(qsgd / topk_qsgd), got {type(sub).__name__}")


def derive_contract(compressor, grads_template,
                    headroom: float = DEFAULT_HEADROOM) -> tuple:
    """Per-leaf shared-scale sub-compressors for ``compressor`` against
    ``grads_template`` (a list of tensors in the JAX tree's leaf order)."""
    per_unit = hasattr(compressor, "for_leaf")
    return tuple(
        _leaf_shared(compressor.for_leaf(i) if per_unit else compressor,
                     g, headroom)
        for i, g in enumerate(grads_template))


class HomomorphicCompressor:
    """Shared-scale wrapper around the config's compressor; workers encode
    through ``for_leaf(i)``, the server averages with
    :func:`homomorphic_mean`."""

    def __init__(self, base, grads_template,
                 headroom: float = DEFAULT_HEADROOM):
        self.base = base
        self.headroom = headroom
        self._subs = derive_contract(base, grads_template, headroom)
        self._crc = None

    @property
    def plan(self):
        """The wrapped planned compressor's plan (adaptive runs only)."""
        return self.base.plan

    def for_leaf(self, i: int):
        return self._subs[i]

    def contract_checksum(self) -> int:
        """CRC32 over every leaf's f32 scale bytes: two endpoints that
        derived different grids get different checksums."""
        if self._crc is None:
            crc = 0
            for sub in self._subs:
                scales = getattr(sub, "scales", None)
                if scales is not None:
                    arr = scales.detach().to("cpu", torch.float32).numpy()
                    crc = zlib.crc32(np.ascontiguousarray(arr).tobytes(), crc)
            self._crc = crc
        return self._crc

    def compress(self, key, tensor):  # pragma: no cover - misuse guard
        raise TypeError("HomomorphicCompressor is per-unit; dispatch "
                        "through for_leaf(i) (compress_tree_fn does)")

    decompress = compress

    def wire_bytes(self, shape, unit: Optional[int] = None) -> int:
        if unit is None:
            raise TypeError("HomomorphicCompressor.wire_bytes needs the "
                            "unit index (per-leaf scale contracts)")
        return int(self._subs[unit].wire_bytes(shape))


def priced_wire_bytes(sub, n: int) -> int:
    """Shared-scale wire bytes of one unit given its base sub-compressor
    (the analytic wire plan holds no scale template)."""
    if isinstance(sub, none.NoneCompressor):
        return n * 4
    if isinstance(sub, qsgd.QSGDCompressor):
        return qsgd.shared_wire_bytes(n)
    if isinstance(sub, chain.TopKQSGDCompressor):
        return chain.shared_wire_bytes(n, sub.compress_ratio)
    raise TypeError(
        f"no shared-scale wire for {type(sub).__name__} "
        "(--server-agg homomorphic supports qsgd / topk_qsgd)")


def make_homomorphic(compressor, grads_template,
                     headroom: float = DEFAULT_HEADROOM):
    """The one constructor every surface uses, so both endpoints wrap
    identically."""
    if compressor is None:
        raise ValueError("--server-agg homomorphic needs a compressed "
                         "config: dense f32 pushes already sum without a "
                         "decode, so there is nothing to save")
    return HomomorphicCompressor(compressor, grads_template, headroom)


#: Each compressor's decode sets, by (divisor, device): the layout of its
#: quantized leaves' sums and means, packed once (``kernels.DecodeSet``).
_DECODE_SETS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def decode_set_for(compressor, leaves: list, k: int, device):
    """The :class:`kernels.DecodeSet` of ``compressor``'s quantized
    ``leaves`` (``[(index, n)]``) at divisor ``k`` on ``device``, built at
    its first apply and kept while every leaf's scales are the ones it
    packed."""
    subs = [compressor.for_leaf(i) for i, _ in leaves]
    sets = _DECODE_SETS.setdefault(compressor, {})
    key = (k, str(device), tuple(leaves))
    hit = sets.get(key)
    if hit is not None and all(a is b.scales for a, b in zip(hit[0], subs)):
        return hit[1]
    dset = kernels.DecodeSet([(n, sub.scales, k, sub.block)
                              for (_, n), sub in zip(leaves, subs)], device)
    sets[key] = ([sub.scales for sub in subs], dset)
    return dset


def homomorphic_mean(compressor: HomomorphicCompressor, payload_trees,
                     k: Optional[int] = None) -> list:
    """Mean gradients (a list in leaf order) of K same-contract payload
    lists: every quantized leaf's exact integer sum into one int32 arena,
    then all their dequantizes in one decode set (``kernels.DecodeSet``:
    one launch of the decode kernel for up to 448 leaves on the card);
    dense leaves average in f32. ``k`` overrides the divisor when the
    payloads are weighted partial sums (an aggregation tree's
    pseudo-pushes: the mean divides by the total leaf count, not by
    ``len(payload_trees)``)."""
    k_div = len(payload_trees) if k is None else int(k)
    out, quantized = [], []
    for i in range(len(payload_trees[0])):
        sub = compressor.for_leaf(i)
        ps = [t[i] for t in payload_trees]
        if isinstance(sub, none.NoneCompressor):
            stack = torch.stack([p.values for p in ps]).to(torch.float32)
            if k is None:
                # jnp.mean as XLA lowers it: the sum times f32(1/K) (bit
                # for bit at K <= 4; wider sums add in another order).
                out.append((stack.sum(dim=0)
                            * kernels.f32_scalar(1.0 / len(ps)))
                           .reshape(ps[0].shape))
            else:
                out.append((stack.sum(dim=0) / kernels.f32_scalar(float(k)))
                           .reshape(ps[0].shape))
        else:
            quantized.append((i, sub, ps))
            out.append(None)
    if not quantized:
        return out
    device = quantized[0][2][0].levels.device
    dset = decode_set_for(
        compressor, [(i, numel(ps[0].shape)) for i, _, ps in quantized],
        k_div, device)
    acc = dset.acc_arena()
    for (_, sub, ps), view in zip(quantized, dset.views(acc)):
        if k is None:
            sub.homomorphic_sum(ps, out=view)
        else:
            sub.homomorphic_sum(ps, k=k, out=view)
    for (i, _, ps), mean in zip(quantized, dset.decode(acc)):
        out[i] = mean.reshape(ps[0].shape)
    return out


# -- the aggregation tree (``homomorphic.py:223-281``) --------------------------

#: The mid-tier wire is int16: a subtree's exact partial sum of clipped
#: int8 levels is bounded by weight x s.
INT16_WIRE_MAX = 2**15 - 1


def max_subtree_weight(s: int) -> int:
    """The most leaves one mid-tier hop carries at level budget ``s``
    without overflowing the int16 wire."""
    return INT16_WIRE_MAX // max(1, int(s))


def check_tier_budget(s: int, weight: int) -> None:
    """Raise unless a ``weight``-leaf subtree sum of clipped levels fits the
    int16 mid-tier wire."""
    if weight > max_subtree_weight(s):
        raise ValueError(
            f"aggtree subtree of {weight} leaves at s={s} can reach "
            f"{weight * s}, overflowing the int16 mid-tier wire; one hop "
            f"admits at most {max_subtree_weight(s)} leaves")


def tree_max_cohort(s: int, n_aggs: int) -> int:
    """The cohort ceiling of an armed tree: the lesser of the root's int32
    budget and ``n_aggs`` hops of :func:`max_subtree_weight` leaves."""
    return min(qsgd.max_world_for(s), int(n_aggs) * max_subtree_weight(s))


def widen_payload_tree(template: list) -> list:
    """The int16 twin of a shared-scale payload list: the schema an
    aggregation tree's root registers. Other payloads have no widened form
    (``config.validate_agg_tree`` refuses their configs)."""
    def widen(p):
        if isinstance(p, qsgd.SharedScaleQSGDPayload):
            return qsgd.SharedScaleQSGDPayload(
                levels=p.levels.to(torch.int16), shape=p.shape, s=p.s,
                block=p.block)
        raise TypeError(
            f"aggtree has no widened wire form for {type(p).__name__} "
            "(dense shared-scale QSGD payloads only)")

    return [widen(p) for p in template]
