"""The rule pack: each module encodes ONE repo contract as a check.

Rule ids are stable API — they appear in suppression comments and the
committed baseline, so renaming one is a breaking change. Per-file rules
see one :class:`FileContext` at a time; the whole-program rules
(``lock-order``, ``guarded-by-flow``, ``wire-protocol``) subclass
:class:`~ewdml_tpu_torch.analysis.engine.ProjectRule` and run once over the
second-pass :class:`~ewdml_tpu_torch.analysis.project.ProjectContext`.
"""

from __future__ import annotations

from ewdml_tpu_torch.analysis.rules.clock import ClockRule
from ewdml_tpu_torch.analysis.rules.config_hash import ConfigHashRule
from ewdml_tpu_torch.analysis.rules.guarded_flow import GuardedFlowRule
from ewdml_tpu_torch.analysis.rules.jit_purity import JitPurityRule
from ewdml_tpu_torch.analysis.rules.lock_discipline import LockDisciplineRule
from ewdml_tpu_torch.analysis.rules.lock_order import LockOrderRule
from ewdml_tpu_torch.analysis.rules.metric_name import MetricNameRule
from ewdml_tpu_torch.analysis.rules.prng import PrngRule
from ewdml_tpu_torch.analysis.rules.trace_name import TraceNameRule
from ewdml_tpu_torch.analysis.rules.wire_protocol import WireProtocolRule

ALL_RULES = (ClockRule, PrngRule, ConfigHashRule, JitPurityRule,
             LockDisciplineRule, MetricNameRule, TraceNameRule,
             LockOrderRule, GuardedFlowRule, WireProtocolRule)


def make_rules():
    return [cls() for cls in ALL_RULES]


def rule_ids():
    return [cls.id for cls in ALL_RULES]
