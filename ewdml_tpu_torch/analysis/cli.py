"""``python -m ewdml_tpu_torch.cli lint`` — the lint entry point (stdlib only).

Defaults lint the installed ``ewdml_tpu_torch`` package against the committed
baseline (``ewdml_tpu_torch/analysis/baseline.json``). Exit codes: 0 clean,
1 findings (new violations or stale baseline entries), 2 usage error.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def _package_dir() -> str:
    import ewdml_tpu_torch
    return os.path.dirname(os.path.abspath(ewdml_tpu_torch.__file__))


def default_baseline_path() -> str:
    return os.path.join(_package_dir(), "analysis", "baseline.json")


def _git_unquote(path: str) -> str:
    """Undo git's C-style path quoting (``"a\\303\\244.py"`` for
    non-ASCII / special characters) — a quoted path left verbatim would
    never match a real file and the --changed scope would silently drop
    it."""
    if not (path.startswith('"') and path.endswith('"') and len(path) >= 2):
        return path
    body = path[1:-1]
    try:
        # unicode_escape folds \303 etc. to latin-1 code points == the
        # raw UTF-8 bytes; re-encode and decode them as UTF-8.
        return body.encode("latin-1", "backslashreplace") \
            .decode("unicode_escape").encode("latin-1") \
            .decode("utf-8", "surrogateescape")
    except (UnicodeDecodeError, UnicodeEncodeError):
        return body


def changed_files(anchor: str):
    """The git-changed ``*.py`` set (staged + unstaged + untracked),
    absolute paths — or None when ``anchor`` is not inside a work tree
    or git itself fails/times out (the ``--changed`` fast loop then
    falls back to the full run — it must degrade to MORE coverage, never
    crash or silently narrow)."""
    anchor_dir = anchor if os.path.isdir(anchor) else os.path.dirname(anchor)
    try:
        top = subprocess.run(
            ["git", "-C", anchor_dir, "rev-parse", "--show-toplevel"],
            capture_output=True, text=True, timeout=30)
        if top.returncode != 0:
            return None
        root = top.stdout.strip()
        st = subprocess.run(
            ["git", "-C", root, "-c", "core.quotePath=false", "status",
             "--porcelain", "-uall"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if st.returncode != 0:
        return None
    out = set()
    for line in st.stdout.splitlines():
        if len(line) < 4:
            continue
        path = line[3:]
        if " -> " in path:  # rename: lint the new side
            path = path.split(" -> ", 1)[1]
        path = _git_unquote(path.strip())
        if path.endswith(".py"):
            # realpath, not abspath: git resolves symlinks in its
            # toplevel, the walker may reach the same file through a
            # symlinked argument — the scope match must agree (engine
            # compares realpaths too).
            out.add(os.path.realpath(os.path.join(root, path)))
    return out


def main(argv=None) -> int:
    from ewdml_tpu_torch.analysis import engine
    from ewdml_tpu_torch.analysis.rules import make_rules

    p = argparse.ArgumentParser(
        prog="ewdml_tpu_torch.cli lint",
        description="repo-invariant lint: per-file rules (clock, prng, "
                    "config-hash, jit-purity, lock discipline, metric/"
                    "trace names) plus the whole-program phase "
                    "(lock-order, guarded-by-flow, wire-protocol "
                    "endpoint conformance)")
    p.add_argument("paths", nargs="*",
                   help="files/dirs to lint (default: the ewdml_tpu_torch "
                        "package)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable report on stdout")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help="baseline file ('none' disables; default: the "
                        "committed analysis/baseline.json when linting the "
                        "package, none for explicit paths)")
    p.add_argument("--write-baseline", action="store_true",
                   help="record current NEW violations as the baseline "
                        "(adoption only — policy afterwards is "
                        "shrink-only), then exit 0")
    p.add_argument("--changed", action="store_true",
                   help="fast pre-commit loop: per-file rules run only on "
                        "git-changed files (staged+unstaged+untracked); "
                        "the whole-program rules still see every file; "
                        "baseline-staleness is left to the full run. "
                        "Outside a git work tree this falls back to the "
                        "full run.")
    p.add_argument("--list-rules", action="store_true",
                   help="print rule ids and contracts, exit 0")
    try:
        ns = p.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code not in (0, None) else 0
    rules = make_rules()
    if ns.list_rules:
        for r in rules:
            print(f"{r.id:12s} {r.title}")
        print("suppress: '# ewdml: allow[rule-id] -- reason' on the "
              "violation line (or a standalone comment line above)")
        return 0
    default_scope = not ns.paths
    paths = ns.paths or [_package_dir()]
    for path in paths:
        if not os.path.exists(path):
            print(f"lint: no such path: {path}", file=sys.stderr)
            return 2
    if ns.baseline == "none":
        baseline_path = None
    elif ns.baseline:
        baseline_path = ns.baseline
    else:
        # Explicit paths default to NO baseline: the committed baseline's
        # keys are package-relative and would all read as stale.
        baseline_path = default_baseline_path() if default_scope else None
    if ns.write_baseline:
        if baseline_path is None:
            # Explicit paths key violations relative to THEIR base — writing
            # them into the committed package baseline would turn every
            # entry stale on the next package lint. Make the target explicit.
            print("lint: --write-baseline with explicit paths needs "
                  "--baseline PATH (the committed package baseline is only "
                  "the default for the default scope)", file=sys.stderr)
            return 2
        report = engine.run_lint(paths, rules=rules, baseline_path=None)
        # Pseudo-rule findings (parse / allow-reason / stale-allow) are
        # never baselineable: they bypass the baseline on the read side,
        # so grandfathering them would write entries that read back as
        # instantly-stale AND leave the finding red — fix the lines
        # instead.
        baselineable = [v for v in report.new
                        if v.rule not in engine.PSEUDO_RULES]
        skipped = len(report.new) - len(baselineable)
        counts = engine.write_baseline(baseline_path, baselineable)
        target = baseline_path
        print(f"lint: wrote {sum(counts.values())} entr(y/ies) "
              f"({len(counts)} distinct) to {target}")
        if skipped:
            print(f"lint: {skipped} parse/allow-reason/stale-allow "
                  f"finding(s) NOT baselined (not grandfatherable — fix "
                  f"the lines)", file=sys.stderr)
        return 0
    file_scope = None
    if ns.changed:
        # Union over EVERY path argument's work tree (they may live in
        # different repos); any path outside a work tree means the scope
        # cannot be trusted — degrade to the full run, never narrow.
        file_scope = set()
        for path in paths:
            scope = changed_files(os.path.abspath(path))
            if scope is None:
                file_scope = None
                break
            file_scope |= scope
        if file_scope is None:
            print("lint: --changed outside a git work tree — running the "
                  "full scope", file=sys.stderr)
    # Explicit paths are a SUBSET of the program: allows naming project
    # rules can't be judged stale there (the other endpoint/class may be
    # out of view). The default scope is the whole package — complete.
    report = engine.run_lint(paths, rules=rules, baseline_path=baseline_path,
                             file_scope=file_scope,
                             project_complete=default_scope)
    print(engine.render_json(report) if ns.as_json
          else engine.render_text(report))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
