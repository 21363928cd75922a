"""The decision engine the three exchange surfaces drive
(``ewdml_tpu/adapt/runtime.py``).

One :class:`AdaptRuntime` per adaptive run (the sync trainer's host loop,
the in-process parameter server, or the TCP ``ps_net`` server; ``surface``
says which). It owns the mode dispatch:

- ``variance``: streaming estimator, byte-budget controller and journal.
  ``on_window(step, moments, comm_frac)`` folds the rank-shared moment
  sample, decides against the comm/comp ratio the caller passes (the
  trainer's bytes-proportional estimate or a measured probe; None on the
  parameter-server surfaces) and journals every decision, switched or
  not, keyed by step.
- ``replay``: decisions come from the recorded ledger as data: the step
  is looked up and the journaled plan applied verbatim.

The one difference from the JAX package: the comm/comp ratio is an
argument, never read from a process-global gauge. Both modes observe the
decision latency into the caller's registry (histogram
``adapt.decision_latency_s``, gauge ``adapt.plan_version``) and emit an
``adapt/decision`` trace instant with the plan summary.
"""

from __future__ import annotations

import os
from typing import Optional

from ewdml_tpu_torch.adapt import ledger as aledger
from ewdml_tpu_torch.adapt.controller import VarianceController
from ewdml_tpu_torch.adapt.plan import (Plan, build_planned_compressor,
                                        plan_wire_bytes, static_plan)
from ewdml_tpu_torch.adapt.variance import StreamingMoments
from ewdml_tpu_torch.obs import clock
from ewdml_tpu_torch.obs import trace as otrace
from ewdml_tpu_torch.obs.registry import MetricsRegistry

MODES = ("off", "variance", "replay")


def validate_config(cfg, surface: str = "trainer") -> None:
    """Refuse at config time what the controller does not support
    (``runtime.py:45-94``, the same messages)."""
    if cfg.adapt not in MODES:
        raise ValueError(f"--adapt must be one of {MODES}, "
                         f"got {cfg.adapt!r}")
    if cfg.adapt == "off":
        return
    if not cfg.compression_enabled:
        raise ValueError("--adapt needs a compressed config to adapt "
                         "(--compress-grad qsgd/topk_qsgd or a method "
                         "preset); dense runs have no rate to tune")
    if cfg.adapt == "replay" and not cfg.adapt_ledger:
        raise ValueError("--adapt replay needs --adapt-ledger <path> "
                         "(the recorded decision sequence)")
    if cfg.adapt_every < 1 and cfg.adapt == "variance":
        raise ValueError("--adapt-every must be >= 1")
    if cfg.lossy_weights_down:
        raise ValueError("--adapt is incompatible with the "
                         "--lossy-weights-down negative-result mode")
    if surface == "trainer":
        if cfg.collective == "fused_q":
            raise ValueError("--adapt requires the gather collective: "
                             "fused_q is a dense ring transport with no "
                             "per-leaf payloads to re-plan (and dense "
                             "configs have no rate to tune) — see "
                             "core.config.validate_collective")
        if cfg.num_slices > 1:
            raise ValueError("--adapt supports single-slice meshes only "
                             "(the hierarchical DCN exchange re-quantizes "
                             "per hop; adapt there is future work)")
        if cfg.gather_type in ("ring", "ring_rs"):
            raise ValueError("--adapt requires the default all_gather "
                             "transport (ring transports requantize "
                             "partial sums per hop)")
        if getattr(cfg, "overlap", "off") != "off":
            raise ValueError("--adapt is incompatible with --overlap "
                             "bucket: a plan switch would re-bucket the "
                             "wave schedule mid-run — see "
                             "core.config.validate_overlap")
    else:
        if cfg.ps_down == "delta":
            raise ValueError("--adapt on the PS paths requires --ps-down "
                             "weights (a method switch would desynchronize "
                             "the compressed delta stream)")


def resolve_ledger_path(cfg) -> str:
    """``--adapt-ledger`` wins; else the ledger lives beside the run's
    checkpoints."""
    return (cfg.adapt_ledger
            or os.path.join(cfg.train_dir or "output/models/",
                            "adapt_ledger.jsonl"))


class AdaptRuntime:
    """Mode dispatch and journaling; host-side only, so a decision adds no
    work to the step. ``registry`` receives the decision instruments (a
    private one when None)."""

    def __init__(self, cfg, names, sizes, *, surface: str = "trainer",
                 start_step: int = 0,
                 registry: Optional[MetricsRegistry] = None):
        validate_config(cfg, surface=surface)
        assert cfg.adapt != "off", "AdaptRuntime is for adaptive modes only"
        self.cfg = cfg
        self.mode = cfg.adapt
        self.surface = surface
        self.registry = registry if registry is not None else MetricsRegistry()
        self.every = max(1, int(cfg.adapt_every))
        self.names, self.sizes = list(names), list(sizes)
        self.ledger_path = resolve_ledger_path(cfg)
        # Under --server-agg homomorphic on the parameter-server surfaces
        # the shipped wire is the shared-scale int8 encode: the budget, the
        # rung prices and the journaled bytes all price that wire.
        self.wire = ("homomorphic"
                     if (surface == "ps"
                         and getattr(cfg, "server_agg", "decode")
                         == "homomorphic")
                     else "payload")
        base = static_plan(cfg, self.names, self.sizes)
        static_bytes = plan_wire_bytes(base, self.sizes,
                                       exact=cfg.topk_exact,
                                       block=cfg.qsgd_block,
                                       wire=self.wire)
        self.budget_bytes = (int(cfg.adapt_budget_mb * 1e6)
                             if cfg.adapt_budget_mb > 0 else static_bytes)
        #: (step, plan) pairs applied this run, the initial plan included:
        #: the replay oracle compares it with the recording's.
        self.applied: list = []
        self._compressors: dict = {}
        # The homomorphic scale contract (set_scale_base): every plan's
        # compressor comes back wrapped, scales renegotiated per plan.
        self._scale_base = None
        self._scale_headroom = None
        self.estimator = StreamingMoments(len(self.sizes))
        if self.mode == "replay":
            self.schedule = aledger.ReplaySchedule.from_path(self.ledger_path)
            self.ledger = None
            self.controller = None
            plan = self.schedule.plan_at_or_before(start_step) or base
        else:
            self.schedule = None
            self.controller = VarianceController(
                self.names, self.sizes, budget_bytes=self.budget_bytes,
                block=cfg.qsgd_block, exact=cfg.topk_exact, wire=self.wire)
            self.ledger = aledger.DecisionLedger(self.ledger_path, meta={
                "mode": self.mode, "surface": surface, "wire": self.wire,
                "units": self.names, "sizes": self.sizes,
                "budget_bytes": self.budget_bytes,
                "adapt_every": self.every, "start_step": int(start_step),
                "compress_grad": cfg.compress_grad,
                "quantum_num": cfg.quantum_num,
                "topk_ratio": cfg.topk_ratio,
            })
            plan = Plan(version=0, step=int(start_step),
                        decisions=base.decisions)
            self.ledger.append_decision(
                plan, trigger="init", switched=False,
                bytes_per_sync=static_bytes)
        self.plan = plan
        self.applied.append((int(plan.step), plan))

    # -- engine -----------------------------------------------------------
    def due(self, step: int) -> bool:
        """Is ``step`` a decision boundary? Variance mode decides on the
        fixed cadence; replay exactly where the recording did."""
        if self.mode == "replay":
            return self.schedule.has(step)
        return step > 0 and step % self.every == 0

    def fast_forward(self, step: int) -> Optional[Plan]:
        """On resume, adopt the plan in force at the restored ``step``:
        replay reads the recorded schedule, variance mode its own ledger
        (a retried run must not train under the base plan while its
        journal says a richer plan is in force). The adoption is journaled
        (trigger ``resume``) and continues the recorded version numbering.
        Returns the plan when it differs from the current one."""
        if self.mode == "replay":
            plan = self.schedule.plan_at_or_before(step)
        else:
            decisions = aledger.read_decisions(self.ledger_path)
            sched = aledger.ReplaySchedule(decisions) if decisions else None
            plan = sched.plan_at_or_before(step) if sched else None
        if plan is None:
            return None
        if plan.key() == self.plan.key():
            self.plan = Plan(version=plan.version, step=self.plan.step,
                             decisions=self.plan.decisions)
            return None
        adopted = Plan(version=plan.version, step=int(step),
                       decisions=plan.decisions)
        self.plan = adopted
        self.applied.append((int(step), adopted))
        if self.ledger is not None:
            self.ledger.append_decision(adopted, trigger="resume",
                                        switched=True)
        return adopted

    def on_window(self, step: int, moments,
                  comm_frac: Optional[float] = None) -> Optional[Plan]:
        """Fold the window's moment sample and decide against
        ``comm_frac`` (the comm share of the step, or None when the
        caller has none). Returns the new plan when the program must
        switch, None when the current plan stands."""
        t0 = clock.monotonic()
        if moments is not None:
            self.estimator.update(moments)
        if self.mode == "replay":
            plan, trigger, signals, nbytes = (
                self.schedule.plan_at(step), "replay", None, None)
            switched = plan.key() != self.plan.key()
        else:
            variance = self.estimator.variance()
            plan = self.controller.decide(step, variance, comm_frac,
                                          version=self.plan.version + 1)
            switched = plan.key() != self.plan.key()
            if not switched:
                plan = Plan(version=self.plan.version, step=step,
                            decisions=self.plan.decisions)
            nbytes = self.controller.plan_bytes(plan)
            signals = {
                "comm_frac": comm_frac,
                "variance_mean": float(variance.mean()),
                "variance_max": float(variance.max()),
                "effective_budget": self.controller.effective_budget(
                    comm_frac),
            }
            trigger = "variance"
        latency = clock.monotonic() - t0
        self.registry.histogram("adapt.decision_latency_s").observe(latency)
        self.registry.gauge("adapt.plan_version").set(plan.version)
        otrace.instant("adapt/decision", step=step, switched=switched,
                       trigger=trigger, **plan.summary())
        if self.ledger is not None:
            self.ledger.append_decision(plan, trigger=trigger,
                                        switched=switched, signals=signals,
                                        bytes_per_sync=nbytes,
                                        latency_s=latency)
        if not switched:
            return None
        self.plan = plan
        self.applied.append((int(step), plan))
        return plan

    def set_scale_base(self, grads_template) -> None:
        """Arm homomorphic scale renegotiation (``--server-agg
        homomorphic``): from here on every :meth:`compressor` result is
        wrapped with a shared-scale contract derived from
        ``grads_template`` (a list of tensors in the JAX leaf order), one
        renegotiation per plan. The headroom is
        ``ops.homomorphic.DEFAULT_HEADROOM`` on every endpoint: the wire
        carries only ``plan_version``. Call before the first
        ``compressor()``."""
        from ewdml_tpu_torch.ops.homomorphic import DEFAULT_HEADROOM

        self._scale_base = grads_template
        self._scale_headroom = DEFAULT_HEADROOM
        self._compressors.clear()

    def compressor(self, plan: Optional[Plan] = None):
        """The planned compressor for ``plan`` (default: the current one),
        cached by plan key; homomorphic-wrapped once
        :meth:`set_scale_base` is armed."""
        plan = plan or self.plan
        key = plan.key()
        comp = self._compressors.get(key)
        if comp is None:
            comp = build_planned_compressor(
                plan, exact=self.cfg.topk_exact, block=self.cfg.qsgd_block)
            if self._scale_base is not None:
                from ewdml_tpu_torch.ops.homomorphic import make_homomorphic

                comp = make_homomorphic(comp, self._scale_base,
                                        self._scale_headroom)
            self._compressors[key] = comp
        return comp

    def close(self) -> None:
        if self.ledger is not None:
            self.ledger.close()
