"""Compression plans: per-unit decisions as data, and their compressor
(``ewdml_tpu/adapt/plan.py``).

A :class:`Plan` is the controller's (or the replay ledger's) output: one
:class:`UnitDecision` per transport unit. Adaptive runs always use
per-layer transport units (``fusion='none'``), so a unit is a gradient
leaf, named as ``train/metrics.wire_plan`` names its rows (the JAX
``leaf_path_name``: ``conv0/kernel``). Decisions are plain data (method,
quantum count, Top-k fraction) with the JAX package's canonical JSON, so a
ledger written by either package replays in the other.

:class:`PlannedCompressor` turns a plan into the transport's compressor:
``for_leaf(i)`` hands back unit ``i``'s sub-compressor, and every per-leaf
transport (``parallel/collectives.compressed_allreduce``,
``parallel/ps.compress_tree_fn`` and the apply's decompress) dispatches
through it. Sub-compressors come from per-config caches (``ops/chain.
reconfigure`` for the Top-k -> QSGD stack), so switching plans mid-run
reuses instances.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ewdml_tpu_torch.ops import packing

#: Decision methods; ``dense`` ships raw f32.
METHODS = ("dense", "qsgd", "topk_qsgd")


@dataclasses.dataclass(frozen=True)
class UnitDecision:
    """One unit's compression choice. ``s`` is the QSGD quantum count (the
    bit width is ``ops.packing.width_for(s)``); ``ratio`` is the Top-k keep
    fraction (``topk_qsgd`` only)."""

    unit: int
    name: str
    method: str
    s: int = 0
    ratio: float = 0.0

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"unknown method {self.method!r}; "
                             f"know {METHODS}")

    def key(self) -> tuple:
        """Identity of the choice (unit and name excluded): what must match
        for two plans to build the same step."""
        return (self.method, int(self.s), round(float(self.ratio), 6))

    def to_json(self) -> dict:
        d = {"u": self.unit, "name": self.name, "method": self.method}
        if self.method != "dense":
            d["s"] = int(self.s)
            d["bits"] = packing.width_for(self.s)
        if self.method == "topk_qsgd":
            d["ratio"] = round(float(self.ratio), 6)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "UnitDecision":
        return cls(unit=int(d["u"]), name=str(d["name"]),
                   method=str(d["method"]), s=int(d.get("s", 0)),
                   ratio=float(d.get("ratio", 0.0)))


@dataclasses.dataclass(frozen=True)
class Plan:
    """An ordered decision per transport unit, stamped with the version the
    journal assigned and the step the decision was made at."""

    version: int
    step: int
    decisions: tuple

    def key(self) -> tuple:
        """Program identity: the per-unit decision keys only (the
        trainer's plan-keyed step cache and the journal's ``switched``
        flag hang off it)."""
        return tuple(d.key() for d in self.decisions)

    def to_json(self) -> dict:
        return {"version": self.version, "step": self.step,
                "decisions": [d.to_json() for d in self.decisions]}

    @classmethod
    def from_json(cls, d: dict) -> "Plan":
        return cls(version=int(d["version"]), step=int(d["step"]),
                   decisions=tuple(UnitDecision.from_json(x)
                                   for x in d["decisions"]))

    def method_counts(self) -> dict:
        out: dict = {}
        for d in self.decisions:
            out[d.method] = out.get(d.method, 0) + 1
        return out

    def summary(self) -> dict:
        """The journal's and the trace's view: the method histogram and
        the dominant (method, bits, fraction)."""
        counts = self.method_counts()
        dom = max(counts, key=lambda m: (counts[m], m))
        picks = [d for d in self.decisions if d.method == dom]
        return {
            "methods": counts,
            "method": dom,
            "bits": packing.width_for(picks[0].s) if dom != "dense" else 32,
            "fraction": (round(picks[0].ratio, 6) if dom == "topk_qsgd"
                         else None),
        }


def unit_names_and_sizes(leaves):
    """Per-leaf ``(names, sizes)`` of ``leaves``, a list of ``(name,
    shape)`` pairs or ``models/convert.LeafSpec`` in the JAX tree's leaf
    order; a name given as a path of keys is joined as
    ``train/metrics.leaf_path_name`` joins it, so the names are the JAX
    package's letter for letter."""
    from ewdml_tpu_torch.ops.bytes import numel
    from ewdml_tpu_torch.train.metrics import leaf_path_name

    names, sizes = [], []
    for leaf in leaves:
        name, shape = ((leaf.name, leaf.jax_shape) if hasattr(leaf, "name")
                       else leaf)
        names.append(name if isinstance(name, str)
                     else leaf_path_name(name))
        sizes.append(int(numel(tuple(shape))))
    return names, sizes


def static_plan(cfg, names, sizes) -> Plan:
    """Plan version 0: every unit at the config's own static compressor,
    payload-identical to the non-adaptive run."""
    del sizes
    name = (cfg.compress_grad or "none").lower()
    if name in ("compress", "qsgd"):
        mk = lambda u, n: UnitDecision(u, n, "qsgd", s=cfg.quantum_num)  # noqa: E731
    elif name in ("topk_qsgd", "topk-qsgd", "method5"):
        mk = lambda u, n: UnitDecision(u, n, "topk_qsgd", s=cfg.quantum_num,  # noqa: E731
                                       ratio=cfg.topk_ratio)
    else:
        raise ValueError(
            f"--adapt needs a QSGD-family --compress-grad to adapt from "
            f"(qsgd/topk_qsgd); got {cfg.compress_grad!r}")
    return Plan(version=0, step=0,
                decisions=tuple(mk(u, n) for u, n in enumerate(names)))


# Per-config sub-compressor caches: the controller flips the same few rungs
# on and off across decisions, so instances are reused, never re-created.
_QSGD_CACHE: dict = {}
_DENSE: Optional[object] = None


def _unit_compressor(decision: UnitDecision, *, exact=None,
                     block: Optional[int] = None):
    global _DENSE
    if decision.method == "dense":
        if _DENSE is None:
            from ewdml_tpu_torch.ops.none import NoneCompressor

            _DENSE = NoneCompressor()
        return _DENSE
    if decision.method == "qsgd":
        key = (decision.s, block)
        comp = _QSGD_CACHE.get(key)
        if comp is None:
            from ewdml_tpu_torch.ops.qsgd import QSGDCompressor

            comp = _QSGD_CACHE[key] = QSGDCompressor(decision.s, block=block)
        return comp
    from ewdml_tpu_torch.ops.chain import TopKQSGDCompressor, reconfigure

    return reconfigure(TopKQSGDCompressor, s=decision.s,
                       fraction=decision.ratio, exact=exact, block=block)


class PlannedCompressor:
    """Per-unit compressor dispatch for one :class:`Plan`. Transport code
    dispatches through ``for_leaf(i)``; a direct ``compress`` or
    ``decompress`` (which leaf?) raises, and ``wire_bytes`` takes the unit
    index."""

    def __init__(self, plan: Plan, *, exact=None,
                 block: Optional[int] = None):
        self.plan = plan
        self._subs = tuple(_unit_compressor(d, exact=exact, block=block)
                           for d in plan.decisions)

    def for_leaf(self, i: int):
        return self._subs[i]

    def compress(self, key, tensor):
        raise TypeError("PlannedCompressor is per-unit; dispatch through "
                        "for_leaf(i) (collectives/compress_tree_fn do)")

    decompress = compress

    def wire_bytes(self, shape, unit: Optional[int] = None) -> int:
        if unit is None:
            raise TypeError("PlannedCompressor.wire_bytes needs the unit "
                            "index (per-unit decisions)")
        return int(self._subs[unit].wire_bytes(shape))


def build_planned_compressor(plan: Plan, *, exact=None,
                             block: Optional[int] = None) -> PlannedCompressor:
    """The one constructor every surface (the trainer, the in-process
    server, the TCP server and worker) uses, so a plan shipped over the
    wire rebuilds the same transform on both ends."""
    return PlannedCompressor(plan, exact=exact, block=block)


def homomorphic_unit_bytes(method: str, s: int, ratio: float, n: int) -> int:
    """Wire bytes of one unit under the shared-scale (homomorphic) encode:
    unpacked int8 levels whatever ``s``, no per-push norms
    (``qsgd.shared_wire_bytes`` / ``chain.shared_wire_bytes``)."""
    del s
    if method == "dense":
        return n * 4
    if method == "qsgd":
        from ewdml_tpu_torch.ops.qsgd import shared_wire_bytes

        return shared_wire_bytes(n)
    if method == "topk_qsgd":
        from ewdml_tpu_torch.ops.chain import shared_wire_bytes

        return shared_wire_bytes(n, ratio)
    raise ValueError(f"no shared-scale wire for method {method!r}")


def plan_wire_bytes(plan: Plan, sizes, *, exact=None,
                    block: Optional[int] = None,
                    wire: str = "payload") -> int:
    """Up-link payload bytes of one sync step under ``plan``, the quantity
    the controller budgets; ``wire='homomorphic'`` prices the shared-scale
    encode (``--server-agg homomorphic``)."""
    if wire == "homomorphic":
        return sum(homomorphic_unit_bytes(d.method, d.s, d.ratio, n)
                   for d, n in zip(plan.decisions, sizes))
    comp = build_planned_compressor(plan, exact=exact, block=block)
    return sum(comp.wire_bytes((n,), unit=i) for i, n in enumerate(sizes))
