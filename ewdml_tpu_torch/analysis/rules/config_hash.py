"""config-hash: every TrainConfig field decides its ledger fate explicitly.

The experiments ledger keys each cell by a content hash of
``TrainConfig.canonical_dict``; adding a field without deciding whether it
belongs in the hash silently invalidates every completed ledger (each
new knob forces the 12-cell table to re-run). The contract: ``core/config.py`` carries an explicit
``HASH_INCLUDED`` / ``HASH_EXCLUDED`` registry and every dataclass field
of ``TrainConfig`` appears in exactly one of them — so the next field-add
is a conscious decision, surfaced at lint time, not a surprise at resume
time. (The runtime twin lives in ``tests/test_config.py``: the registries
must exactly cover ``TrainConfig.__dataclass_fields__`` and
``canonical_dict`` must exclude exactly ``HASH_EXCLUDED``.)
"""

from __future__ import annotations

import ast

from ewdml_tpu_torch.analysis.engine import Rule, walk

CONFIG_CLASS = "TrainConfig"
REGISTRY_NAMES = ("HASH_INCLUDED", "HASH_EXCLUDED")


def _registry_literal(node) -> list | None:
    """Tuple/list/set of string constants -> the names (else None)."""
    if not isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return None
    names = []
    for elt in node.elts:
        if not (isinstance(elt, ast.Constant) and isinstance(elt.value, str)):
            return None
        names.append(elt.value)
    return names


class ConfigHashRule(Rule):
    id = "config-hash"
    title = ("every TrainConfig field must appear in exactly one of "
             "HASH_INCLUDED/HASH_EXCLUDED")

    def check(self, ctx):
        cls = next((n for n in walk(ctx.tree)
                    if isinstance(n, ast.ClassDef) and n.name == CONFIG_CLASS),
                   None)
        if cls is None:
            return []
        # Dataclass fields = annotated class-level assignments.
        fields: dict[str, int] = {}
        for stmt in cls.body:
            if (isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)):
                fields[stmt.target.id] = stmt.lineno
        registries: dict[str, tuple[list, int]] = {}
        for stmt in ctx.tree.body:
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and stmt.targets[0].id in REGISTRY_NAMES):
                names = _registry_literal(stmt.value)
                if names is None:
                    return [ctx.violation(
                        self.id, stmt,
                        f"{stmt.targets[0].id} must be a literal "
                        f"tuple/list of field-name strings (the registry "
                        f"is data the linter can read)")]
                registries[stmt.targets[0].id] = (names, stmt.lineno)
        missing = [r for r in REGISTRY_NAMES if r not in registries]
        if missing:
            return [ctx.violation(
                self.id, cls,
                f"{CONFIG_CLASS} has no {'/'.join(missing)} registr"
                f"{'y' if len(missing) == 1 else 'ies'}: every field must "
                f"declare whether it enters canonical_dict hashes (the "
                f"ledger-invalidation footgun)")]
        included, inc_line = registries["HASH_INCLUDED"]
        excluded, exc_line = registries["HASH_EXCLUDED"]
        out = []
        for name, line in fields.items():
            in_inc, in_exc = name in included, name in excluded
            if in_inc and in_exc:
                out.append(ctx.violation(
                    self.id, line,
                    f"field {name!r} is in BOTH HASH_INCLUDED and "
                    f"HASH_EXCLUDED"))
            elif not in_inc and not in_exc:
                out.append(ctx.violation(
                    self.id, line,
                    f"field {name!r} is in neither HASH_INCLUDED nor "
                    f"HASH_EXCLUDED — decide its ledger fate (does it "
                    f"change the math, or is it run-local?)"))
        for name in included:
            if name not in fields:
                out.append(ctx.violation(
                    self.id, inc_line,
                    f"HASH_INCLUDED entry {name!r} is not a "
                    f"{CONFIG_CLASS} field"))
        for name in excluded:
            if name not in fields:
                out.append(ctx.violation(
                    self.id, exc_line,
                    f"HASH_EXCLUDED entry {name!r} is not a "
                    f"{CONFIG_CLASS} field"))
        return out
