"""prng: determinism needs explicit seed plumbing, not ambient randomness.

Two shapes of violation, both of which break the repo's replay contracts
(``--adapt replay`` bit-identity, seeded stochastic rounding, the
experiments ledger's content-hash resume):

- **Hidden global generators.** ``np.random.<fn>(...)`` module-level
  convenience calls (incl. ``np.random.seed``) draw from numpy's HIDDEN
  process-global generator — any import-order change reshuffles every
  downstream draw. Construct a seeded ``np.random.RandomState(seed)`` /
  ``np.random.default_rng(seed)`` instead (what
  ``data/{datasets,loader,readers}.py`` already do). The torch twins are
  ``torch.manual_seed`` / ``torch.cuda.manual_seed[_all]`` (they reseed
  the process-global generators) and the sampling calls
  ``torch.{rand,randn,randint,randperm,bernoulli,multinomial,normal}``
  made without ``generator=`` (they draw from them).
- **Int-literal keys.** ``prng.key(0)`` (``utils/prng.py``, the port of
  ``jax.random.key``) and ``torch.Generator(...).manual_seed(0)`` bare
  INT-LITERAL seeds in library code pin a stream the caller cannot thread
  a seed into. Derive keys from ``cfg.seed`` via ``fold_in``
  (``utils/prng.py``); the deliberate template-warming sites (where the
  payload is discarded and only the schema matters) carry ``allow[prng]``
  with the reason.
"""

from __future__ import annotations

import ast

from ewdml_tpu_torch.analysis.engine import Rule, walk

#: Seeded-constructor surface of ``numpy.random`` — explicitly allowed
#: (the caller owns the seed). Everything else on the module is the
#: global-state convenience API.
NP_ALLOWED = frozenset({
    "RandomState", "default_rng", "Generator", "SeedSequence",
    "BitGenerator", "MT19937", "PCG64", "PCG64DXSM", "Philox", "SFC64",
})

#: ``torch.<fn>`` sampling calls that draw from the process-global
#: generator unless handed ``generator=``.
TORCH_SAMPLERS = frozenset({
    "rand", "randn", "randint", "randperm", "bernoulli", "multinomial",
    "normal",
})

#: Calls that reseed a process-global torch generator.
TORCH_GLOBAL_SEEDERS = frozenset({
    "torch.manual_seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all",
})


def _np_random_member(func) -> str | None:
    """``np.random.X`` / ``numpy.random.X`` -> ``X`` (else None)."""
    if (isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Attribute)
            and func.value.attr == "random"
            and isinstance(func.value.value, ast.Name)
            and func.value.value.id in ("np", "numpy")):
        return func.attr
    return None


def _dotted(func) -> str | None:
    """``torch.cuda.manual_seed`` as the string it spells (else None)."""
    parts = []
    while isinstance(func, ast.Attribute):
        parts.append(func.attr)
        func = func.value
    if not isinstance(func, ast.Name):
        return None
    parts.append(func.id)
    return ".".join(reversed(parts))


def _is_key_ctor(func, key_names) -> bool:
    """``prng.key`` (the ``utils/prng`` module, however it was bound) or a
    bare ``key`` imported from it; ``torch.Generator(...).manual_seed``."""
    if isinstance(func, ast.Name):
        return func.id in key_names
    if not isinstance(func, ast.Attribute):
        return False
    if func.attr == "key":
        return isinstance(func.value, ast.Name) and func.value.id == "prng"
    if func.attr == "manual_seed":
        ctor = func.value
        return (isinstance(ctor, ast.Call)
                and _dotted(ctor.func) in ("torch.Generator", "Generator"))
    return False


def _imported_key_names(tree) -> set:
    """Local names bound to ``utils.prng.key`` by a from-import."""
    names = set()
    for node in walk(tree):
        if (isinstance(node, ast.ImportFrom) and node.module
                and node.module.endswith("utils.prng")):
            names.update(a.asname or a.name for a in node.names
                         if a.name == "key")
    return names


class PrngRule(Rule):
    id = "prng"
    title = ("no hidden-global np.random/torch generator calls; no bare "
             "literal PRNG keys in library code")

    def check(self, ctx):
        key_names = _imported_key_names(ctx.tree)
        out = []
        for node in walk(ctx.tree):
            if isinstance(node, ast.Call):
                member = _np_random_member(node.func)
                dotted = _dotted(node.func)
                if member is not None and member not in NP_ALLOWED:
                    out.append(ctx.violation(
                        self.id, node,
                        f"np.random.{member} draws from the hidden "
                        f"process-global PRNG; construct a seeded "
                        f"np.random.default_rng(seed)/RandomState(seed)"))
                elif (member in NP_ALLOWED
                      and not node.args and not node.keywords):
                    # The constructor is only disciplined when the caller
                    # actually owns the seed: a bare default_rng() /
                    # RandomState() seeds from OS entropy — hidden
                    # nondeterminism with a reassuring name.
                    out.append(ctx.violation(
                        self.id, node,
                        f"np.random.{member}() without a seed draws OS "
                        f"entropy; pass an explicit seed (or allow[prng] "
                        f"with a reason if nondeterminism is intended)"))
                elif dotted in TORCH_GLOBAL_SEEDERS:
                    out.append(ctx.violation(
                        self.id, node,
                        f"{dotted} reseeds the hidden process-global torch "
                        f"generator; seed a torch.Generator the caller "
                        f"owns and pass it as generator="))
                elif (dotted is not None and dotted.startswith("torch.")
                      and dotted[len("torch."):] in TORCH_SAMPLERS
                      and not any(k.arg == "generator"
                                  for k in node.keywords)):
                    out.append(ctx.violation(
                        self.id, node,
                        f"{dotted}() without generator= draws from the "
                        f"hidden process-global torch generator; pass a "
                        f"seeded torch.Generator"))
                elif (_is_key_ctor(node.func, key_names)
                      and len(node.args) == 1
                      and isinstance(node.args[0], ast.Constant)
                      and type(node.args[0].value) is int):
                    out.append(ctx.violation(
                        self.id, node,
                        f"bare literal PRNG key "
                        f"({ast.unparse(node.func)}({node.args[0].value})) "
                        f"in library code; derive from cfg.seed via "
                        f"fold_in (utils/prng.py), or allow[prng] with a "
                        f"reason if the stream is genuinely discarded"))
            elif (isinstance(node, ast.ImportFrom)
                  and node.module in ("numpy.random", "np.random")):
                for alias in node.names:
                    if alias.name not in NP_ALLOWED:
                        out.append(ctx.violation(
                            self.id, node,
                            f"'from numpy.random import {alias.name}' "
                            f"imports the hidden-global API; use a seeded "
                            f"Generator/RandomState"))
        return out
