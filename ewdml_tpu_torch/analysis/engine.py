"""Visitor-based AST rule engine: walker, suppressions, baseline, reports.

Design contract (mirrors how torch.distributed-era projects wire
sanitizers instead of review checklists):

- **Rules** are small classes with an ``id`` and a ``check(ctx)`` method
  returning :class:`Violation` rows; each file is parsed ONCE and every
  rule sees the same :class:`FileContext` (source, AST, comment map).
- **Suppression** is per line: ``# ewdml: allow[rule-id] -- reason`` on
  the violation's own line, or in the contiguous standalone-comment
  block directly above it (justifications may span several comment
  lines). The reason is REQUIRED — an allow without one does suppress
  its target (so the finding isn't double-reported) but is itself
  reported under the ``allow-reason`` pseudo-rule, keeping the exit code
  red until someone writes down why.
- **Baseline** (shrink-only): a committed JSON of grandfathered
  violation keys. Keys are line-number-free — ``path::rule::snippet`` —
  so unrelated edits above a grandfathered line don't churn the file.
  A baselined violation is reported as covered; a baseline entry with no
  matching violation is STALE and fails the run (the fix must shrink the
  baseline in the same change — entries may never be re-added for new
  code, only recorded once via ``--write-baseline`` at adoption time).
- **Stale allows** (shrink-only, the suppression twin of the baseline
  policy): an ``allow[rule]`` comment that no longer suppresses any
  finding is itself reported as ``stale-allow`` — suppression debt can
  only go down, never silently linger after the violation is fixed.
- **Whole-program phase**: after every file is parsed, rules
  subclassing :class:`ProjectRule` run once over a
  :class:`~ewdml_tpu_torch.analysis.project.ProjectContext` (all files, class
  facts, one-level call graph) — the lock-order / guarded-by-flow /
  wire-protocol invariants are cross-file by nature. ``file_scope``
  (the ``--changed`` pre-commit loop) restricts the PER-FILE rules and
  allow-staleness to a subset while project rules still see everything;
  baseline staleness is skipped in scoped mode (enforcing it is the
  full run's job — a scoped run cannot tell fixed from unscanned).

Exit semantics (:func:`ReportData.ok`): clean = no new violations AND no
stale baseline entries.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize
from typing import Iterable, Optional

#: ``# ewdml: allow[<rule-id>]`` with an optional ``-- reason`` tail; the
#: bracket accepts a comma-separated rule list. (The angle brackets here
#: keep THIS doc-comment outside the pattern — the typo'd-id check would
#: otherwise flag the linter's own documentation.)
ALLOW_RE = re.compile(
    r"#\s*ewdml:\s*allow\[([A-Za-z0-9_,\- ]+)\]\s*(?:--\s*(\S.*))?")

#: ``# ewdml: guarded-by[_lock]`` — attribute-annotation consumed by the
#: lock-discipline rule (parsed here so every rule shares one comment map).
GUARDED_RE = re.compile(r"#\s*ewdml:\s*guarded-by\[([A-Za-z_][A-Za-z0-9_]*)\]")

#: ``# ewdml: requires[_update_lock]`` — METHOD annotation (def line, or
#: the contiguous comment block above the def/decorators): the method body
#: is analyzed as holding the lock, and ``guarded-by-flow`` checks every
#: intra-class caller provably holds it. Comma list accepted.
REQUIRES_RE = re.compile(
    r"#\s*ewdml:\s*requires\[([A-Za-z_][A-Za-z0-9_, ]*)\]")

#: ``# ewdml: atomic`` — attribute annotation on the defining assignment:
#: the attr is deliberately shared without a lock (single reference
#: store/read under the GIL, torn values impossible and tolerated by
#: design). Consumed by guarded-by-flow's thread-escape check.
ATOMIC_RE = re.compile(r"#\s*ewdml:\s*atomic\b")


def walk(node) -> list:
    """``ast.walk(node)`` as a list, walked once per node and shared by
    every rule that asks (the whole-package run walks each tree many
    times otherwise)."""
    nodes = getattr(node, "_ewdml_nodes", None)
    if nodes is None:
        nodes = node._ewdml_nodes = list(ast.walk(node))
    return nodes


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding. ``snippet`` (the stripped source line) is part of the
    baseline identity so keys survive line-number drift."""

    rule: str
    path: str          # base-relative, posix separators
    line: int
    col: int
    message: str
    snippet: str = ""

    def key(self) -> str:
        return f"{self.path}::{self.rule}::{self.snippet}"

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class _Allow:
    rules: frozenset
    reason: Optional[str]
    line: int
    standalone: bool  # comment is the whole line (may cover the next line)


class FileContext:
    """Everything a rule needs about one file, parsed once."""

    def __init__(self, abspath: str, rel: str, source: str):
        self.abspath = abspath
        self.rel = rel.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=abspath)
        #: line -> raw comment text (tokenize-accurate: a ``# ewdml:``
        #: inside a string literal is NOT a comment and never matches).
        self.comments: dict[int, str] = {}
        self.allows: dict[int, _Allow] = {}
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            row = tok.start[0]
            self.comments[row] = tok.string
            m = ALLOW_RE.search(tok.string)
            if m:
                rules = frozenset(
                    r.strip() for r in m.group(1).split(",") if r.strip())
                standalone = self.lines[row - 1].lstrip().startswith("#")
                self.allows[row] = _Allow(rules, m.group(2), row, standalone)

    def guarded_annotation(self, line: int) -> Optional[str]:
        """Lock name from a ``guarded-by[...]`` comment on ``line``."""
        m = GUARDED_RE.search(self.comments.get(line, ""))
        return m.group(1) if m else None

    def atomic_annotation(self, line: int) -> bool:
        """True when ``line`` carries ``# ewdml: atomic``."""
        return bool(ATOMIC_RE.search(self.comments.get(line, "")))

    def violation(self, rule: str, node, message: str) -> Violation:
        line = getattr(node, "lineno", node if isinstance(node, int) else 1)
        col = getattr(node, "col_offset", 0)
        snippet = (self.lines[line - 1].strip()
                   if 0 < line <= len(self.lines) else "")
        return Violation(rule, self.rel, line, col, message, snippet)

    def _comment_only(self, line: int) -> bool:
        return (0 < line <= len(self.lines)
                and self.lines[line - 1].lstrip().startswith("#"))

    def allow_for(self, v: Violation) -> Optional[_Allow]:
        """The suppression covering ``v``: same line, or a standalone
        comment in the contiguous comment block directly above (so a
        justification may span several comment lines)."""
        ent = self.allows.get(v.line)
        if ent and v.rule in ent.rules:
            return ent
        line = v.line - 1
        while self._comment_only(line):
            ent = self.allows.get(line)
            if ent and ent.standalone and v.rule in ent.rules:
                return ent
            line -= 1
        return None


class Rule:
    """Base rule: subclasses set ``id``/``title`` and implement ``check``."""

    id = ""
    title = ""

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        raise NotImplementedError


class ProjectRule(Rule):
    """Whole-program rule: runs ONCE over the :class:`ProjectContext`
    after every file is parsed (second pass). Violations still anchor at
    concrete nodes in concrete files, so the per-line suppression and
    baseline machinery apply unchanged."""

    def check(self, ctx: FileContext):
        return ()  # project rules only run in the whole-program phase

    def check_project(self, pctx) -> Iterable[Violation]:
        raise NotImplementedError


def method_requires(ctx: FileContext, fn) -> frozenset:
    """Lock names a method's ``# ewdml: requires[...]`` annotation
    declares: on the ``def`` line, or in the contiguous comment block
    directly above the def (decorators included)."""
    out: set = set()
    anchor = min([fn.lineno] + [d.lineno for d in
                                getattr(fn, "decorator_list", [])])
    m = REQUIRES_RE.search(ctx.comments.get(fn.lineno, ""))
    if m is None:
        m = REQUIRES_RE.search(ctx.comments.get(anchor, ""))
    line = anchor - 1
    while m is None and ctx._comment_only(line):
        m = REQUIRES_RE.search(ctx.comments.get(line, ""))
        line -= 1
    if m:
        out.update(x.strip() for x in m.group(1).split(",") if x.strip())
    return frozenset(out)


@dataclasses.dataclass
class ReportData:
    files: int = 0
    new: list = dataclasses.field(default_factory=list)        # Violation
    baselined: list = dataclasses.field(default_factory=list)  # Violation
    suppressed: int = 0
    stale: list = dataclasses.field(default_factory=list)      # baseline keys
    all_found: list = dataclasses.field(default_factory=list)  # pre-filter

    @property
    def ok(self) -> bool:
        return not self.new and not self.stale


# -- file discovery ---------------------------------------------------------

_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "node_modules"}


def iter_py_files(paths) -> list:
    out = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            out.append(p)
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if d not in _SKIP_DIRS and not d.startswith("."))
            out.extend(os.path.join(root, f) for f in sorted(files)
                       if f.endswith(".py"))
    return out


def _default_base(paths) -> str:
    """Base dir violations are keyed relative to: the common parent of the
    argument paths, one level ABOVE a directory argument so the package
    name stays in the key (``ewdml_tpu_torch/parallel/ps.py``, stable no matter
    the invoking cwd — baseline keys must not depend on where lint ran)."""
    parents = []
    for p in paths:
        p = os.path.abspath(p)
        parents.append(os.path.dirname(p if not p.endswith(os.sep)
                                       else p.rstrip(os.sep)))
    return os.path.commonpath(parents) if parents else os.getcwd()


# -- baseline ---------------------------------------------------------------

BASELINE_VERSION = 1

#: Engine-level pseudo-rules: produced outside the normal rule pipeline,
#: never suppressible by ``allow[...]`` and never baselineable — a parse
#: failure, a reasonless allow, or a stale allow is fixed by editing the
#: line, not grandfathered.
PSEUDO_RULES = frozenset({"parse", "allow-reason", "stale-allow"})


def load_baseline(path: Optional[str]) -> dict:
    """Baseline file -> ``{key: count}``. Missing/None -> empty."""
    if not path or not os.path.isfile(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    entries = data.get("entries", {})
    return {str(k): int(v) for k, v in entries.items()}


def write_baseline(path: str, violations) -> dict:
    counts: dict[str, int] = {}
    for v in violations:
        counts[v.key()] = counts.get(v.key(), 0) + 1
    payload = {
        "version": BASELINE_VERSION,
        "policy": "shrink-only: entries are removed when fixed, never added",
        "entries": dict(sorted(counts.items())),
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=False)
        f.write("\n")
    return counts


# -- engine -----------------------------------------------------------------

def _registered_rule_ids() -> set:
    """Every id in the registered rule pack (regardless of which rules a
    caller passed) — the 'does this rule even exist' oracle for typo'd
    allow comments."""
    from ewdml_tpu_torch.analysis.rules import rule_ids
    return set(rule_ids())


def run_lint(paths, rules=None, baseline_path: Optional[str] = None,
             base: Optional[str] = None,
             file_scope: Optional[set] = None,
             project_complete: bool = True) -> ReportData:
    """Run ``rules`` over every ``*.py`` under ``paths``.

    Returns a :class:`ReportData`; callers decide process exit from
    ``report.ok``. A file that fails to parse is itself a finding (rule
    ``parse``) — a syntax error must not silently shrink coverage.

    ``file_scope`` (a set of absolute paths, the ``--changed`` loop):
    per-file rules and allow-staleness run only on scoped files; PROJECT
    rules still see every parsed file (a partial whole-program view would
    invent asymmetries), and the baseline-staleness check is skipped
    (only the full run can tell a fixed violation from an unscanned one).

    ``project_complete=False`` declares that ``paths`` are a SUBSET of
    the program (the CLI's explicit-path invocations): allows naming
    project rules are then exempt from staleness — a wire-protocol
    suppression in a client-only file looks unused simply because the
    server half is out of view, not because the violation was fixed.
    """
    if rules is None:
        from ewdml_tpu_torch.analysis.rules import make_rules
        rules = make_rules()
    file_rules = [r for r in rules if not isinstance(r, ProjectRule)]
    project_rules = [r for r in rules if isinstance(r, ProjectRule)]
    base = os.path.abspath(base) if base else _default_base(paths)
    if file_scope is not None:
        file_scope = {os.path.realpath(p) for p in file_scope}
    baseline = dict(load_baseline(baseline_path))
    report = ReportData()
    contexts: list[FileContext] = []
    in_scope: dict[str, bool] = {}  # rel -> per-file rules ran here
    found_by_rel: dict[str, list] = {}
    for f in iter_py_files(paths):
        report.files += 1
        rel = os.path.relpath(f, base)
        if rel.startswith(".."):
            rel = f  # outside the base: keep it unambiguous
        try:
            with open(f, encoding="utf-8") as fh:
                src = fh.read()
            ctx = FileContext(f, rel, src)
        except (SyntaxError, UnicodeDecodeError, tokenize.TokenError) as e:
            # Parse findings are never scope-filtered: a broken file also
            # blinds the whole-program phase.
            report.new.append(Violation(
                "parse", rel.replace(os.sep, "/"),
                getattr(e, "lineno", 1) or 1, 0, f"cannot parse: {e}"))
            continue
        contexts.append(ctx)
        # realpath on both sides: the scope set (git-derived) holds
        # physical paths, the walker may reach a file via a symlink.
        scoped = file_scope is None or os.path.realpath(f) in file_scope
        in_scope[ctx.rel] = scoped
        if scoped:
            found: list[Violation] = []
            for rule in file_rules:
                found.extend(rule.check(ctx))
            found_by_rel[ctx.rel] = found
    if project_rules and contexts:
        from ewdml_tpu_torch.analysis.project import ProjectContext

        pctx = ProjectContext(contexts)
        for rule in project_rules:
            for v in rule.check_project(pctx):
                found_by_rel.setdefault(v.path, []).append(v)
    # Which allow targets can be judged for staleness: per-file rule ids
    # whenever the file was scanned, project ids only when the project
    # view was complete. An id in NO registered rule at all is a typo —
    # reported, not silently exempt (dead suppression debt forever).
    judgeable = {r.id for r in file_rules}
    if project_complete:
        judgeable |= {r.id for r in project_rules}
    known_ids = {r.id for r in rules} | _registered_rule_ids()
    for ctx in contexts:
        found = found_by_rel.get(ctx.rel, [])
        # Reasonless allows are findings too (see module docstring): the
        # suppression works, the missing justification keeps lint red.
        seen_reasonless: set[int] = set()
        used_allow_lines: set[int] = set()
        for v in sorted(found, key=lambda v: (v.line, v.col, v.rule)):
            report.all_found.append(v)
            allow = ctx.allow_for(v)
            if allow is not None:
                report.suppressed += 1
                used_allow_lines.add(allow.line)
                if allow.reason is None and allow.line not in seen_reasonless:
                    seen_reasonless.add(allow.line)
                    snip = (ctx.lines[allow.line - 1].strip()
                            if allow.line <= len(ctx.lines) else "")
                    report.new.append(Violation(
                        "allow-reason", ctx.rel, allow.line, 0,
                        "allow[...] without a reason — write "
                        "'# ewdml: allow[rule] -- why'", snip))
                continue
            if baseline.get(v.key(), 0) > 0:
                baseline[v.key()] -= 1
                report.baselined.append(v)
                continue
            report.new.append(v)
        # Stale-suppression detection (shrink-only, like the baseline): an
        # allow that covered nothing this run is dead weight — the
        # violation was fixed, so the comment must go too. Only judged
        # where every rule the allow could serve actually ran: per-file
        # rules need the file in scope; allows naming a project rule need
        # the project phase (always on when project rules exist).
        if not in_scope.get(ctx.rel, False):
            continue
        for line, allow in sorted(ctx.allows.items()):
            if line in used_allow_lines:
                continue
            snip = (ctx.lines[line - 1].strip()
                    if line <= len(ctx.lines) else "")
            pseudo = allow.rules & PSEUDO_RULES
            if pseudo:
                report.new.append(Violation(
                    "stale-allow", ctx.rel, line, 0,
                    f"allow[{', '.join(sorted(pseudo))}] targets an "
                    f"engine pseudo-rule, which cannot be suppressed — "
                    f"fix the underlying line instead", snip))
                continue
            unknown = allow.rules - known_ids
            if unknown:
                report.new.append(Violation(
                    "stale-allow", ctx.rel, line, 0,
                    f"allow[{', '.join(sorted(unknown))}] names no "
                    f"registered rule (typo?) — it can never suppress "
                    f"anything; fix the id or delete the comment", snip))
                continue
            if not allow.rules <= judgeable:
                continue  # names a rule this run couldn't judge
            report.new.append(Violation(
                "stale-allow", ctx.rel, line, 0,
                f"allow[{', '.join(sorted(allow.rules))}] suppresses "
                f"nothing — the violation is gone; delete the comment "
                f"(suppression debt is shrink-only)", snip))
    if file_scope is None:
        report.stale = sorted(k for k, n in baseline.items() if n > 0)
    return report


# -- reporters --------------------------------------------------------------

def render_text(report: ReportData) -> str:
    lines = [v.render() for v in report.new]
    for key in report.stale:
        lines.append(
            f"{key.split('::')[0]}: [baseline] stale entry (the violation "
            f"is gone — shrink the baseline): {key}")
    lines.append(
        f"lint: {report.files} files, {len(report.new)} violation(s), "
        f"{len(report.baselined)} baselined, {report.suppressed} "
        f"suppressed, {len(report.stale)} stale baseline entr(y/ies)"
        + (" — OK" if report.ok else " — FAIL"))
    return "\n".join(lines)


def render_json(report: ReportData) -> str:
    return json.dumps({
        "files": report.files,
        "ok": report.ok,
        "violations": [v.as_dict() for v in report.new],
        "baselined": [v.as_dict() for v in report.baselined],
        "suppressed": report.suppressed,
        "stale_baseline": list(report.stale),
    }, indent=1)
