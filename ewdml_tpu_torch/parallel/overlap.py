"""Bucketed backward pipelining, ``--overlap bucket`` (``ewdml_tpu/parallel/overlap.py``).

The gradient tree is partitioned by :func:`plan_buckets` into size-balanced
buckets ordered last-produced-first (the reverse flatten order: backward
produces the last layers' gradients first), and each bucket's exchange is
one collective (dense with the bf16 wire, the ``fused_q`` ring, or the
compressed gather transport with the bucket as one fused payload), keyed by
``fold_in(fold_in(fold_in(step_key, TAG), TAG), b)`` so replicas stay
bit-identical and bucket streams never collide. The JAX package leaves the
overlap to XLA's scheduler; here it is an explicit schedule:

- **On the card** (:class:`StreamSchedule`): the W workers run one after
  another in one process (``core/world.LocalWorld``). While the last
  worker's backward runs, a post-accumulate-grad hook on each of its
  parameters counts the bucket's leaves down, and the moment a bucket has
  all of them its exchange is issued on a side CUDA stream (forked from the
  backward's stream by an event), so it runs under the rest of the
  backward. Before the optimizer the backward's stream joins the side
  stream. Under a window's CUDA graph the fork and the join are captured
  with the step.
- **On the CPU**, or with :func:`configure` ``("inline")``: the same
  buckets run one after another after the backward.

The two schedules launch the same kernels on the same inputs and keys, so
they give bit-equal results; only the order of launches differs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ewdml_tpu_torch.parallel import collectives
from ewdml_tpu_torch.utils import prng

#: PRNG stream tag of the per-bucket key chain (``overlap.py:69``).
OVERLAP_TAG = 0x0B07

#: Auto bucket count ceiling (``--overlap-buckets 0``): the wave schedule's
#: returns diminish fast — bucket B's exchange can only hide behind buckets
#: produced after it, and past ~4 waves the per-bucket payloads on this
#: repo's trees drop under the per-collective launch cost.
OVERLAP_AUTO_MAX_BUCKETS = 4

#: Auto mode's balance requirement: max/min bucket bytes. A tree that cannot
#: partition this evenly at N buckets gets fewer buckets (LeNet's fc1 kernel
#: is 93% of the tree — auto collapses it to ONE bucket rather than ship a
#: schedule whose first wave is 15x the rest and hides nothing).
OVERLAP_BALANCE_RATIO = 2.0


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Deterministic partition of a gradient tree into exchange buckets.

    ``buckets[b]`` holds tree-flatten leaf indices; bucket 0 is the
    LAST-PRODUCED-FIRST bucket (the end of the flatten order — what the
    backward pass materializes first), and indices within a bucket run in
    production order (descending flatten index).
    """

    buckets: tuple
    bucket_bytes: tuple  # f32 gradient bytes per bucket (the balance metric
                         # and the predictor's backward-compute proxy)

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def balance_ratio(self) -> float:
        return max(self.bucket_bytes) / max(1, min(self.bucket_bytes))

    def leaf_to_bucket(self) -> dict:
        """flatten-index -> bucket index (the wire plan's aggregation map)."""
        return {i: b for b, idxs in enumerate(self.buckets) for i in idxs}


def _min_max_contiguous(sizes: Sequence[int], k: int):
    """Contiguous partition of ``sizes`` into ``k`` non-empty groups
    minimizing the largest group sum (the classic linear-partition DP) —
    deterministic: ties break toward the earliest boundary."""
    n = len(sizes)
    k = max(1, min(k, n))
    prefix = [0]
    for s in sizes:
        prefix.append(prefix[-1] + s)
    inf = float("inf")
    # dp[j][i]: minimal max-sum splitting the first i items into j groups.
    dp = [[inf] * (n + 1) for _ in range(k + 1)]
    cut = [[0] * (n + 1) for _ in range(k + 1)]
    dp[0][0] = 0.0
    for j in range(1, k + 1):
        for i in range(j, n + 1):
            best, best_t = inf, j - 1
            for t in range(j - 1, i):
                cand = max(dp[j - 1][t], prefix[i] - prefix[t])
                if cand < best:
                    best, best_t = cand, t
            dp[j][i] = best
            cut[j][i] = best_t
    groups, i = [], n
    for j in range(k, 0, -1):
        t = cut[j][i]
        groups.append(list(range(t, i)))
        i = t
    groups.reverse()
    return groups


def plan_buckets(leaf_bytes: Sequence[int], n_buckets: int = 0) -> BucketPlan:
    """Partition a gradient tree (per-leaf f32 bytes, tree-flatten order)
    into size-balanced exchange buckets ordered last-produced-first.

    ``n_buckets == 0`` (``--overlap-buckets`` auto) picks the largest bucket
    count ``<=`` :data:`OVERLAP_AUTO_MAX_BUCKETS` whose best contiguous
    partition stays within :data:`OVERLAP_BALANCE_RATIO` (max/min bucket
    bytes), falling back to one bucket — a skewed tree never gets a schedule
    whose waves cannot balance. An explicit ``n_buckets`` is honored exactly
    (clamped to the leaf count), best-effort balanced: the operator's call,
    e.g. to force a multi-wave pipeline on a skewed smoke-test tree.

    Pure host arithmetic on static shapes, and the one definition shared
    by the trainer's exchange and the analytic wire plan
    (``train/metrics.wire_plan``).
    """
    L = len(leaf_bytes)
    if L == 0:
        raise ValueError("cannot bucket an empty gradient tree")
    rev = list(reversed(list(leaf_bytes)))  # production (backward) order
    if n_buckets:
        groups = _min_max_contiguous(rev, int(n_buckets))
    else:
        # Descending search always terminates with an assignment: at k=1
        # the single group's max == min, so the balance check holds.
        for k in range(min(OVERLAP_AUTO_MAX_BUCKETS, L), 0, -1):
            groups = _min_max_contiguous(rev, k)
            bb = [sum(rev[i] for i in g) for g in groups]
            if max(bb) <= OVERLAP_BALANCE_RATIO * min(bb):
                break
    buckets = tuple(tuple(L - 1 - p for p in g) for g in groups)
    return BucketPlan(
        buckets=buckets,
        bucket_bytes=tuple(sum(leaf_bytes[i] for i in g) for g in buckets),
    )


def predict_overlap_frac(bucket_wire_bytes: Sequence[float],
                         bucket_grad_bytes: Sequence[float],
                         comm_frac: Optional[float]) -> Optional[float]:
    """Predicted fraction of exchange time the bucketed schedule hides.

    A deterministic wave-schedule simulation over one sync step, in
    normalized time units (comp + comm = 1, split by ``comm_frac``, a
    measured or estimated comm/compute split the caller passes):
    bucket ``b``'s gradients materialize when the backward has produced its
    cumulative grad bytes (compute time proportional to f32 gradient bytes
    — the same proxy the planner balances on), its wire time is its share
    of the per-bucket wire bytes, and the link is serial — bucket ``b+1``'s
    exchange waits for both its own cotangents and a free link:

        ready_b = comp * cum_grad_b / total_grad
        end_b   = max(ready_b, end_{b-1}) + comm * wire_b / total_wire

    Overlapped step time is ``max(comp, end_last)``; the prediction is the
    hidden share ``(comp + comm - overlapped) / comm``. One bucket -> 0.0
    (the monolithic barrier); the last bucket's wire time is structurally
    exposed, so the prediction never reaches 1.0. Returns None when
    ``comm_frac`` is unknown — a prediction without the split would be an
    invented number.
    """
    if comm_frac is None:
        return None
    comm = min(1.0, max(0.0, float(comm_frac)))
    comp = 1.0 - comm
    if len(bucket_wire_bytes) <= 1 or comm <= 0.0:
        return 0.0
    total_wire = float(sum(bucket_wire_bytes))
    total_grad = float(sum(bucket_grad_bytes))
    if total_wire <= 0 or total_grad <= 0:
        return 0.0
    produced, link_free = 0.0, 0.0
    for wb, gb in zip(bucket_wire_bytes, bucket_grad_bytes):
        produced += gb
        ready = comp * produced / total_grad
        link_free = max(ready, link_free) + comm * wb / total_wire
    overlapped = max(comp, link_free)
    return max(0.0, min(1.0, (comp + comm - overlapped) / comm))


def bucket_key(step_key, b: int):
    """Bucket ``b``'s key: ``fold_in(fold_in(fold_in(step_key, TAG), TAG),
    b)``."""
    base = prng.fold_in(prng.fold_in(step_key, OVERLAP_TAG), OVERLAP_TAG)
    return prng.fold_in(base, b)


def exchange_bucket(world, sub: list, bkey, *, compressor=None,
                    wire_dtype=None, fused_q: bool = False,
                    num_aggregate: int = 0, relay: bool = False,
                    fuse: bool = False, step=0, return_own: bool = False):
    """One bucket's collective. ``sub[w]`` is worker w's list of the
    bucket's leaves; returns their averages (and, with ``return_own``,
    each worker's own decompressed payload), as
    :func:`bucketed_exchange` describes."""
    if compressor is None:
        if fused_q:
            return collectives.fused_q_allreduce_mean(world, sub, bkey)
        return collectives.dense_allreduce_mean(world, sub,
                                                wire_dtype=wire_dtype)
    return collectives.compressed_allreduce(
        world, sub, compressor, bkey, num_aggregate=num_aggregate,
        relay=relay, relay_key=prng.fold_in(bkey, 0x5EED),
        transport="all_gather", return_own_decompressed=return_own,
        step=step, fuse=fuse and len(sub[0]) > 1)


def bucketed_exchange(world, grads: list, step_key, *, n_buckets: int = 0,
                      compressor=None, wire_dtype=None, fused_q: bool = False,
                      num_aggregate: int = 0, relay: bool = False,
                      fuse: bool = False, step=0, return_own: bool = False):
    """The bucketed exchange (``overlap.py:209-292``), every bucket inline.

    ``grads[w]`` is worker w's list of leaves (JAX leaf order and layout).
    ``compressor is None``: a dense mean per bucket (``wire_dtype`` narrows
    it under the bf16 policy) or, with ``fused_q``, one int8-wire ring per
    bucket. Otherwise one compressed gather per bucket (M4/M5 ``relay``
    with a rank-shared per-bucket key, K-of-N by ``num_aggregate``); with
    ``fuse`` the bucket's leaves ship as one payload. ``return_own`` (error
    feedback, compressed only) also returns each worker's own decompressed
    payload, leaf for leaf."""
    if return_own and compressor is None:
        raise ValueError("return_own requires a compressor (error feedback "
                         "rides the compressed exchange only)")
    n = len(grads[0])
    plan = plan_buckets([g.numel() * 4 for g in grads[0]], n_buckets)
    out = [None] * n
    own = [[None] * n for _ in grads]
    for b, idxs in enumerate(plan.buckets):
        sub = [[g[i] for i in idxs] for g in grads]
        res = exchange_bucket(
            world, sub, bucket_key(step_key, b), compressor=compressor,
            wire_dtype=wire_dtype, fused_q=fused_q,
            num_aggregate=num_aggregate, relay=relay, fuse=fuse, step=step,
            return_own=return_own)
        if return_own:
            res, sub_own = res
            for r, o in enumerate(sub_own):
                for i, g in zip(idxs, o):
                    own[r][i] = g
        for i, g in zip(idxs, res):
            out[i] = g
    return (out, own) if return_own else out


# -- the schedule on the card ---------------------------------------------------

_SCHEDULE = "stream"  # stream | inline


def configure(schedule: str) -> None:
    """Select the card's schedule: ``"stream"`` (each bucket on a side
    stream as its leaves are produced) or ``"inline"`` (every bucket after
    the backward, as on the CPU)."""
    global _SCHEDULE
    if schedule not in ("stream", "inline"):
        raise ValueError(f"unknown overlap schedule {schedule!r}")
    _SCHEDULE = schedule


def use_stream(device) -> bool:
    """Whether buckets are issued on a side stream during the backward."""
    return torch.device(device).type == "cuda" and _SCHEDULE == "stream"


class StreamSchedule:
    """Issue bucket ``b`` (``run(b)``) on ``stream`` once every leaf of it
    has been produced (:meth:`leaf_ready`, called from the backward's
    post-accumulate-grad hooks); :meth:`join` issues any bucket not yet
    issued and makes the current stream wait for the side stream. Each
    issue forks the side stream from the stream the hook runs on, so the
    bucket sees every gradient produced before it."""

    def __init__(self, plan: BucketPlan, run, stream):
        self.plan = plan
        self.run = run
        self.stream = stream
        self.left = [len(idxs) for idxs in plan.buckets]
        self.l2b = plan.leaf_to_bucket()
        self.issued = [False] * plan.n_buckets

    def leaf_ready(self, i: int) -> None:
        b = self.l2b[i]
        self.left[b] -= 1
        if self.left[b] == 0:
            self._issue(b)

    def _issue(self, b: int) -> None:
        self.issued[b] = True
        self.stream.wait_stream(torch.cuda.current_stream(self.stream.device))
        with torch.cuda.stream(self.stream):
            self.run(b)

    def join(self) -> None:
        for b, done in enumerate(self.issued):
            if not done:
                self._issue(b)
        torch.cuda.current_stream(self.stream.device).wait_stream(self.stream)
