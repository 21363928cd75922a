"""Variance-driven adaptive compression, ``--adapt {off,variance,replay}``
(``ewdml_tpu/adapt``).

A streaming per-leaf gradient-variance estimator (``adapt/variance.py``)
and the comm/comp ratio feed a byte-budget controller
(``adapt/controller.py``) that picks per-layer compression (dense, QSGD
bit width, Top-k fraction) at window boundaries. Every decision is
journaled to an append-only JSONL ledger keyed by step
(``adapt/ledger.py``); ``--adapt replay`` re-applies the journaled
sequence as data, so a recorded run reproduces bit for bit. The plans
(``adapt/plan.py``) drive all three exchange surfaces: the sync trainer,
the in-process parameter server and the TCP tier.

``--adapt off`` (the default) consults nothing here: the step is the
non-adaptive one.
"""

from ewdml_tpu_torch.adapt.controller import VarianceController  # noqa: F401
from ewdml_tpu_torch.adapt.ledger import (DecisionLedger,  # noqa: F401
                                          ReplaySchedule, read_decisions)
from ewdml_tpu_torch.adapt.plan import (Plan, PlannedCompressor,  # noqa: F401
                                        UnitDecision,
                                        build_planned_compressor,
                                        static_plan)
from ewdml_tpu_torch.adapt.runtime import (AdaptRuntime,  # noqa: F401
                                           resolve_ledger_path,
                                           validate_config)
from ewdml_tpu_torch.adapt.variance import StreamingMoments  # noqa: F401
