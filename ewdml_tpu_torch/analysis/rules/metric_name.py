"""metric-name: registry keys are literal ``component.name[_unit]`` strings.

The metrics registry (``ewdml_tpu_torch/obs/registry.py``) creates a metric
object per distinct name and holds it forever; the live exporter
(``obs/serve.py``) then renders every name on every scrape. An f-string
metric name interpolating run state — a worker index, a layer name, a
step number — is therefore an unbounded-cardinality footgun twice over:
the registry leaks one object per distinct value, and the scrape payload
grows without bound. Per-op wire latency is a metric family precisely
by CLAMPING the interpolated part to a closed vocabulary
(``ps_net._OPS``); this rule makes that discipline checkable.

Flags any ``counter()`` / ``gauge()`` / ``histogram()`` call on the
registry surface — ``oreg.<m>(...)`` / ``registry.<m>(...)``, the names
imported from ``ewdml_tpu_torch.obs.registry``, and ``self.<m>(...)`` inside
the registry module itself — whose first argument is not a string
literal matching ``component.name[_unit]`` (lowercase dotted, at least
one dot: ``net.bytes_sent``, ``ps_net.push.latency_s``). A call site
whose interpolation IS provably bounded suppresses with the reason
saying why (``# ewdml: allow[metric-name] -- bounded: ...``).
"""

from __future__ import annotations

import ast
import os
import re

from ewdml_tpu_torch.analysis.engine import Rule, walk

#: The registry accessor surface.
METHODS = frozenset({"counter", "gauge", "histogram"})

#: Receiver names that denote the metrics registry at call sites. The
#: repo-wide import idiom is ``from ewdml_tpu_torch.obs import registry as oreg``.
BASES = frozenset({"oreg", "registry"})

#: ``component.name[_unit]``: lowercase dotted path, at least one dot.
NAME_RE = re.compile(r"[a-z][a-z0-9_]*(\.[a-z0-9_]+)+")

#: The registry module itself (its absorbers call ``self.counter(...)``).
REGISTRY_MODULE_SUFFIX = "obs/registry.py"


class MetricNameRule(Rule):
    id = "metric-name"
    title = ("registry metric names must be literal component.name[_unit] "
             "strings — f-string names are an unbounded-cardinality footgun")

    def check(self, ctx):
        in_registry = (ctx.rel.endswith(REGISTRY_MODULE_SUFFIX)
                       or ctx.abspath.replace(os.sep, "/").endswith(
                           "/" + REGISTRY_MODULE_SUFFIX))
        # Accessor names imported directly (``from ...obs.registry import
        # histogram``) count too — the alias smuggles the same registry.
        imported: set[str] = set()
        for node in walk(ctx.tree):
            if (isinstance(node, ast.ImportFrom) and node.module
                    and node.module.endswith("obs.registry")):
                for alias in node.names:
                    if alias.name in METHODS:
                        imported.add(alias.asname or alias.name)
        out = []
        for node in walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in METHODS:
                if not isinstance(fn.value, ast.Name):
                    continue
                base = fn.value.id
                if base not in BASES and not (in_registry and base == "self"):
                    continue
                label = f"{base}.{fn.attr}"
            elif isinstance(fn, ast.Name) and fn.id in imported:
                label = fn.id
            else:
                continue
            if not node.args:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                if not NAME_RE.fullmatch(arg.value):
                    out.append(ctx.violation(
                        self.id, node,
                        f"metric name {arg.value!r} is not "
                        f"component.name[_unit] (lowercase dotted, e.g. "
                        f"'ps_net.push.latency_s')"))
                continue
            kind = ("f-string" if isinstance(arg, ast.JoinedStr)
                    else "non-literal")
            out.append(ctx.violation(
                self.id, node,
                f"{kind} metric name in {label}(): names must be literal "
                f"component.name[_unit] strings (unbounded-cardinality "
                f"footgun — the registry and every /metrics scrape keep "
                f"one entry per distinct name); clamp interpolations to a "
                f"closed vocabulary and allow[metric-name] with the reason"))
        return out
