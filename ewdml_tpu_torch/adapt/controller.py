"""The byte-budget decision rule, Variance-based GC x DynamiQ
(``ewdml_tpu/adapt/controller.py``, copied).

Given the streaming per-unit variance estimate and the comm/comp ratio the
caller passes, pick each unit's rung on a fixed compression ladder so the
total up-link payload stays under a byte budget while the
variance-weighted compression noise is minimized. Every input is explicit
and every tie-break is by unit index, so decisions journal and replay
bit for bit.

1. Ladder (cheapest wire first): Top-k(1%)->QSGD, Top-k(5%)->QSGD, QSGD
   4-bit (s=7, packed), QSGD 8-bit (s=127), dense f32. Bytes per rung come
   from the compressors' own ``wire_bytes``.
2. Budget: ``--adapt-budget-mb``, or (auto) the static config's own
   payload bytes: adaptation reallocates the bytes the static method
   spends, never exceeds them. A comm share above ``TARGET_COMM_FRAC``
   tightens the effective budget below the ceiling (down to half); a low
   share never loosens past it.
3. Greedy fill: every unit starts at its cheapest rung; the unit with the
   largest variance-weighted noise drop per extra byte is upgraded until
   the budget is spent. Noise per rung is ``sqrt(block)/s`` for QSGD plus
   a ``sqrt(1 - ratio)`` sparsification term for the Top-k rungs.
"""

from __future__ import annotations

import math
from typing import Optional

from ewdml_tpu_torch.adapt.plan import Plan, UnitDecision

#: (method, s, ratio) rungs, cheapest wire first. s=7 is the 4-bit packed
#: wire (ops/packing), s=127 the int8 wire the repo defaults to.
DEFAULT_LADDER = (
    ("topk_qsgd", 127, 0.01),
    ("topk_qsgd", 127, 0.05),
    ("qsgd", 7, 0.0),
    ("qsgd", 127, 0.0),
    ("dense", 0, 0.0),
)

#: Target communication share of the fused step. Measured comm fraction
#: above this tightens the budget proportionally (never below half);
#: below it the full budget ceiling applies.
TARGET_COMM_FRAC = 0.2


def _rung_bytes(method: str, s: int, ratio: float, n: int,
                block: Optional[int], exact,
                wire: str = "payload") -> int:
    if wire == "homomorphic":
        # --server-agg homomorphic ships unpacked int8 levels with no
        # per-push norms (ops/homomorphic.py): price THAT wire, or the
        # budget ceiling would be violated by up to 2x on the 4-bit rung.
        from ewdml_tpu_torch.adapt.plan import homomorphic_unit_bytes

        return homomorphic_unit_bytes(method, s, ratio, n)
    from ewdml_tpu_torch.adapt.plan import _unit_compressor

    d = UnitDecision(0, "", method, s=s, ratio=ratio)
    return int(_unit_compressor(d, exact=exact, block=block)
               .wire_bytes((n,)))


def _rung_noise(method: str, s: int, ratio: float, n: int,
                block: Optional[int]) -> float:
    """Relative RMS compression-error proxy for one unit (0 = lossless).
    QSGD's per-element error ratio is ~sqrt(b)/s for b-element norm blocks
    (the repo's own EF-stability analysis); Top-k drops ``1 - ratio`` of
    the energy in the worst case and quantizes the surviving fraction, so
    the error energies add: ``e² = (1-ratio) + ratio·b_k/s²``."""
    if method == "dense":
        return 0.0
    b = min(n, block) if block else n
    if method == "qsgd":
        return math.sqrt(b) / max(1, s)
    k = max(1, int(n * ratio))
    bk = min(k, block) if block else k
    return math.sqrt(max(0.0, 1.0 - ratio)
                     + ratio * bk / max(1, s) ** 2)


class VarianceController:
    """Deterministic per-unit rung allocation under a byte budget."""

    def __init__(self, names, sizes, *, budget_bytes: int,
                 ladder=DEFAULT_LADDER, block: Optional[int] = None,
                 exact=None, wire: str = "payload"):
        self.names = list(names)
        self.sizes = [int(n) for n in sizes]
        self.budget_bytes = int(budget_bytes)
        self.ladder = tuple(ladder)
        self.block = block
        self.exact = exact
        # 'payload' = the compressors' own wire; 'homomorphic' = the
        # shared-scale int8 wire (--server-agg homomorphic). Pricing must
        # match the bytes actually shipped or the ceiling is fiction; on
        # the homomorphic wire the s=7 rung costs the same bytes as s=127
        # at strictly more noise, so the Pareto frontier drops it.
        self.wire = wire
        # Per-unit PARETO frontier over the ladder, cheapest wire first:
        # a rung costing more bytes without strictly less noise at this
        # unit's size is dropped (e.g. per-tensor 4-bit QSGD on a large
        # leaf is both bigger and noisier than a sparse rung), so walking
        # the frontier is guaranteed bytes-up / noise-down — what the
        # greedy upgrade loop needs to terminate at the budget.
        self._frontier, self._bytes, self._noise = [], [], []
        for n in self.sizes:
            cand = sorted(
                ((_rung_bytes(m, s, r, n, block, exact, wire),
                  _rung_noise(m, s, r, n, block), i)
                 for i, (m, s, r) in enumerate(self.ladder)),
                key=lambda t: (t[0], t[1], t[2]))
            rungs, bts, nzs = [], [], []
            for b, nz, i in cand:
                if not nzs or nz < nzs[-1]:
                    rungs.append(i)
                    bts.append(b)
                    nzs.append(nz)
            self._frontier.append(rungs)
            self._bytes.append(bts)
            self._noise.append(nzs)

    def effective_budget(self, comm_frac: Optional[float]) -> int:
        """The budget is a CEILING; a high measured comm share tightens
        below it (down to half), a low share never loosens above it."""
        if comm_frac is None or comm_frac <= TARGET_COMM_FRAC:
            return self.budget_bytes
        scale = max(0.5, TARGET_COMM_FRAC / float(comm_frac))
        return int(self.budget_bytes * scale)

    def decide(self, step: int, variance, comm_frac: Optional[float],
               version: int) -> Plan:
        """Allocate rungs for this window. ``variance`` is the estimator's
        per-unit element variance; the greedy weight is the unit's total
        noise mass ``sqrt(variance * n)`` (an L2-norm scale), so big noisy
        layers win upgrade bytes first."""
        budget = self.effective_budget(comm_frac)
        U = len(self.sizes)
        weight = [math.sqrt(max(0.0, float(variance[u])) * self.sizes[u])
                  for u in range(U)]
        rung = [0] * U
        spent = sum(self._bytes[u][0] for u in range(U))
        # Greedy upgrades along each unit's Pareto frontier: max variance-
        # weighted noise drop per extra byte; ties break toward the lowest
        # unit index (determinism).
        while True:
            best_u, best_gain = -1, 0.0
            for u in range(U):
                r = rung[u]
                if r + 1 >= len(self._frontier[u]):
                    continue
                extra = self._bytes[u][r + 1] - self._bytes[u][r]
                if spent + extra > budget:
                    continue
                gain = (weight[u]
                        * (self._noise[u][r] - self._noise[u][r + 1])
                        / max(1, extra))
                if gain > best_gain:
                    best_u, best_gain = u, gain
            if best_u < 0:
                break
            r = rung[best_u]
            spent += self._bytes[best_u][r + 1] - self._bytes[best_u][r]
            rung[best_u] = r + 1
        decisions = []
        for u in range(U):
            m, s, r = self.ladder[self._frontier[u][rung[u]]]
            decisions.append(UnitDecision(u, self.names[u], m, s=s, ratio=r))
        return Plan(version=version, step=step, decisions=tuple(decisions))

    def plan_bytes(self, plan: Plan) -> int:
        """Up-link payload bytes of ``plan`` under this controller's
        tables (same ``wire_bytes`` accounting as the wire plan)."""
        total = 0
        for u, d in enumerate(plan.decisions):
            total += _rung_bytes(d.method, d.s, d.ratio, self.sizes[u],
                                 self.block, self.exact, self.wire)
        return total
