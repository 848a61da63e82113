"""The port's static analysis CLI (front end for
``ceph_tpu_torch.analysis``).

    python -m ceph_tpu_torch.tools.lint           # the port and chip_smoke.py
    python -m ceph_tpu_torch.tools.lint ceph_tpu_torch/osd    # a subtree
    python -m ceph_tpu_torch.tools.lint --changed     # dirty files + callers
    python -m ceph_tpu_torch.tools.lint --profile     # per-rule wall time
    python -m ceph_tpu_torch.tools.lint --list-rules  # and the omitted ones
    python -m ceph_tpu_torch.tools.lint --rules hole-sentinel ceph_tpu_torch
    python -m ceph_tpu_torch.tools.lint --write-baseline
    python -m ceph_tpu_torch.tools.lint --format json     # or sarif
    python -m ceph_tpu_torch.tools.lint --seam-report OUT.json

Findings print as ``path:line rule message``; exit status is non-zero
when any unsuppressed, unbaselined finding remains.  Suppress a single
site with a trailing ``# lint: disable=<rule> -- why`` comment; park
legacy findings in ``ceph_tpu_torch/tools/lint_baseline.txt`` (kept
empty -- the tree is clean -- but the mechanism is how a new rule lands
without blocking).

``--changed`` parses the WHOLE default tree (the interprocedural
rules need the full call graph either way) but reports findings only
for the git-dirty files plus every module holding a transitive caller
of anything they define -- an edit to a callee can surface
whole-program findings in callers that did not change.

Port of ``tools/lint.py``: the same options, over the port's rules
(``--list-rules`` also names the reference rules the port omits, with
their reasons).  ``--seam-report`` writes only to the path its caller
gives.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

from .. import analysis

TOOLS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(os.path.dirname(TOOLS_DIR))
DEFAULT_PATHS = ["ceph_tpu_torch", "chip_smoke.py"]
DEFAULT_BASELINE = os.path.join(TOOLS_DIR, "lint_baseline.txt")


def to_sarif(findings) -> dict:
    """Minimal SARIF 2.1.0 document (one run, one result per
    finding) -- enough for code-scanning upload and IDE ingestion."""
    rules = sorted({f.rule for f in findings})
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "ceph-tpu-torch-lint",
                "informationUri":
                    "https://example.invalid/ceph_tpu_torch/analysis",
                "rules": [{"id": r} for r in rules],
            }},
            "results": [{
                "ruleId": f.rule,
                "level": "warning",
                "message": {"text": f.message},
                "locations": [{"physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": f.line},
                }}],
            } for f in findings],
        }],
    }


def _in_default_scope(path: str) -> bool:
    """--changed only lints dirty files the full run would cover
    (never e.g. the bad-on-purpose fixture corpus under tests/)."""
    for scope in DEFAULT_PATHS:
        if path == scope or path.startswith(scope + "/"):
            return True
    return False


def changed_files(root: str) -> list[str]:
    """Python files touched per git (worktree + index + untracked),
    restricted to the default lint scope."""
    out = subprocess.run(
        ["git", "status", "--porcelain"], cwd=root,
        capture_output=True, text=True, check=True).stdout
    files = []
    for line in out.splitlines():
        if len(line) < 4 or line[0] == "D" or line[1] == "D":
            continue
        path = line[3:].split(" -> ")[-1].strip().strip('"')
        if (path.endswith(".py") and _in_default_scope(path)
                and os.path.exists(os.path.join(root, path))):
            files.append(path)
    return sorted(set(files))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ceph_tpu_torch.tools.lint",
        description="ceph_tpu_torch project static analysis")
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs to lint (default: "
                         f"{' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--changed", action="store_true",
                    help="report only git-dirty files plus their "
                         "reverse-reachable callers (pre-commit mode)")
    ap.add_argument("--profile", action="store_true",
                    help="print per-rule wall time to stderr")
    ap.add_argument("--rules",
                    help="comma-separated subset of rules to run")
    ap.add_argument("--list-rules", action="store_true",
                    help="print registered rules and exit")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file (default: "
                         "ceph_tpu_torch/tools/lint_baseline.txt)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline file")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline with the current "
                         "unsuppressed findings and exit 0")
    ap.add_argument("--format", choices=["text", "json", "sarif"],
                    default="text",
                    help="findings output format (default: text)")
    ap.add_argument("--seam-report", default=None, metavar="PATH",
                    help="write the process-seam audit (shared-state "
                         "census, wire vocabulary, snapshot races) "
                         "as JSON to PATH and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for checker in analysis.get_checkers():
            print(f"{checker.name:22s} {checker.description}")
        for name, reason in analysis.omitted().items():
            print(f"{name:22s} omitted: {reason}")
        return 0

    rules = (args.rules.split(",") if args.rules else None)
    dirty: list[str] = []
    if args.changed:
        dirty = changed_files(REPO_ROOT)
        if not dirty:
            print("lint: no changed python files", file=sys.stderr)
            return 0
        # the interprocedural rules need the whole program: parse the
        # full default tree, then narrow the REPORT to dirty+callers
        paths = DEFAULT_PATHS
    else:
        paths = args.paths or DEFAULT_PATHS
    if args.seam_report is not None:
        # the audit is whole-program by definition
        paths = DEFAULT_PATHS

    profile: dict[str, float] | None = ({} if args.profile else None)
    try:
        findings, project = analysis.run(paths, root=REPO_ROOT,
                                         rules=rules, profile=profile)
    except KeyError as e:                   # unknown --rules entry
        print(f"lint: {e.args[0]}", file=sys.stderr)
        return 2

    if args.seam_report is not None:
        from ..analysis import seam_report
        report = seam_report.build_report(project)
        out_path = args.seam_report
        with open(out_path, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2, sort_keys=False)
            fh.write("\n")
        s = report["summary"]
        print(f"lint: seam audit -> "
              f"{os.path.relpath(out_path, REPO_ROOT)}: "
              f"{s['shared_state_sites']} shared-state site(s), "
              f"{s['wire_types']} wire type(s), "
              f"{s['daemon_reaches']} daemon reach(es) "
              f"({s['unjustified_daemon_reaches']} unjustified), "
              f"{s['snapshot_races']} snapshot race(s) "
              f"({s['unjustified_snapshot_races']} unjustified)",
              file=sys.stderr)
        return 0

    if args.changed:
        closure = analysis.changed_closure(project, dirty)
        expanded = sorted(closure - set(dirty))
        if expanded:
            print(f"lint: --changed expanded {len(dirty)} dirty "
                  f"file(s) with {len(expanded)} caller file(s)",
                  file=sys.stderr)
        findings = [f for f in findings if f.path in closure]

    if profile is not None:
        total = sum(profile.values())
        for name, secs in sorted(profile.items(),
                                 key=lambda kv: -kv[1]):
            print(f"lint: profile {name:24s} {secs * 1e3:9.1f} ms",
                  file=sys.stderr)
        print(f"lint: profile {'[total]':24s} {total * 1e3:9.1f} ms",
              file=sys.stderr)

    baseline = (set() if args.no_baseline or args.write_baseline
                else analysis.load_baseline(args.baseline))
    kept, n_inline, n_base = analysis.filter_suppressed(
        findings, project, baseline)

    if args.write_baseline:
        analysis.write_baseline(args.baseline, kept)
        print(f"lint: wrote {len(kept)} finding(s) to "
              f"{os.path.relpath(args.baseline, REPO_ROOT)}",
              file=sys.stderr)
        return 0

    if args.format == "json":
        print(json.dumps([dataclasses.asdict(f) for f in kept],
                         indent=2))
    elif args.format == "sarif":
        print(json.dumps(to_sarif(kept), indent=2))
    else:
        for f in kept:
            print(f.render())
    nfiles = len(project.modules)
    extras = []
    if n_inline:
        extras.append(f"{n_inline} inline-suppressed")
    if n_base:
        extras.append(f"{n_base} baselined")
    extra = f" ({', '.join(extras)})" if extras else ""
    print(f"lint: {len(kept)} finding(s) across {nfiles} "
          f"file(s){extra}", file=sys.stderr)
    return 1 if kept else 0


if __name__ == "__main__":
    sys.exit(main())
