"""Repo-invariant static analysis of the port (``ewdml_tpu/analysis``):
the review checklist as executable checks.

The port copies the JAX package's concurrent code, and with it the bug
classes its analysis pass exists for: unlocked reads of lock-guarded
parameter-server state, a new ``TrainConfig`` field silently changing
``canonical_dict`` hashes, and timers drifting from the one monotonic
clock (``obs/clock``). Those invariants are load-bearing — replay
bit-identity, the Method-2 weights-stay-f32 guard, and the resumable
M1-M6 ledger all depend on them — so they are enforced here by a machine
instead of by memory. Module names, rule ids, the ``# ewdml:``
marker syntax, exit codes and the JSON report are the JAX package's, so
an annotation in the port reads as on its counterpart line there.

- ``engine``   visitor-based AST rule engine: file walker, per-line
               ``# ewdml: allow[rule-id] -- reason`` suppressions, a
               committed shrink-only baseline for grandfathered
               violations, text + JSON reporters
- ``project``  the whole-program view the cross-file rules share
- ``rules``    the rule pack encoding the repo's own contracts (clock,
               prng, config-hash, jit-purity, lock discipline, metric and
               trace names, lock order, guarded-by flow, the wire
               protocol)
- ``cli``      ``python -m ewdml_tpu_torch.cli lint`` (also
               ``python -m ewdml_tpu_torch.analysis``) — exit 0 clean /
               1 findings / 2 usage error

Everything here is stdlib-only (``ast`` + ``tokenize``): the linter
imports neither torch nor anything it lints, and needs no device.
"""
