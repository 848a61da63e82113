"""Parse-once module model, suppressions, baseline, and the runner.

One ``ast.parse`` per file feeds every rule (the tree is shared via
``Module``); findings are plain ``path:line rule message`` records.

Suppression layers, innermost first:

* inline ``# lint: disable=<rule>[,<rule>...]`` (or bare ``disable``
  for all rules) on the flagged line, or on a standalone comment line
  immediately above it;
* a checked-in baseline file
  (``ceph_tpu_torch/tools/lint_baseline.txt``) keyed by
  ``path::rule::message`` -- line-number free, so findings survive
  unrelated edits but a *new* instance of an old finding still fires.
"""

from __future__ import annotations

import ast
import io
import os
import time
import tokenize
from dataclasses import dataclass, field
from typing import Iterable

from .registry import ProjectChecker, get_checkers

_SUPPRESS_PREFIX = "lint:"
_SKIP_DIRS = {"__pycache__", ".git", ".hg", "node_modules"}


@dataclass(frozen=True, order=True)
class Finding:
    path: str          # display path (posix, relative to the root)
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"


@dataclass
class Module:
    """One parsed source file shared by all checkers."""

    path: str                     # display path (posix)
    abspath: str
    source: str
    tree: ast.AST
    # line -> set of suppressed rule names; "*" suppresses all rules
    suppressions: dict[int, set[str]] = field(default_factory=dict)

    @classmethod
    def parse(cls, abspath: str, display: str) -> "Module":
        with open(abspath, encoding="utf-8", errors="replace") as f:
            source = f.read()
        tree = ast.parse(source, filename=display)
        mod = cls(path=display, abspath=abspath, source=source,
                  tree=tree)
        mod.suppressions = _scan_suppressions(source)
        return mod

    def suppressed(self, finding: Finding) -> bool:
        rules = self.suppressions.get(finding.line)
        return bool(rules) and ("*" in rules
                                or finding.rule in rules)


@dataclass
class Project:
    modules: list[Module]
    # resolved CallGraph, set by run() when a ProjectChecker ran (or
    # on demand via graph()); callers may also build it themselves
    callgraph: object | None = None

    def by_path(self) -> dict[str, Module]:
        return {m.path: m for m in self.modules}

    def graph(self):
        """The interprocedural CallGraph, built on first use."""
        if self.callgraph is None:
            from .callgraph import CallGraph
            self.callgraph = CallGraph.build(self)
        return self.callgraph


def _scan_suppressions(source: str) -> dict[int, set[str]]:
    """Comment tokens of the form ``# lint: disable[=r1,r2]``.

    A trailing comment suppresses its own line; a standalone comment
    line suppresses itself and the next line (so the directive can sit
    above long expressions).
    """
    out: dict[int, set[str]] = {}
    try:
        tokens = list(tokenize.generate_tokens(
            io.StringIO(source).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        text = tok.string.lstrip("#").strip()
        if not text.startswith(_SUPPRESS_PREFIX):
            continue
        directive = text[len(_SUPPRESS_PREFIX):].strip()
        if not directive.startswith("disable"):
            continue
        # "disable=<rules> -- why": the justification rides the
        # directive so the hop and its reason live on one line
        rest = directive[len("disable"):].split("--", 1)[0].strip()
        if rest.startswith("="):
            rules = {r.strip() for r in rest[1:].split(",")
                     if r.strip()}
        elif rest:
            continue               # e.g. "disablefoo": not a directive
        else:
            rules = {"*"}
        line = tok.start[0]
        out.setdefault(line, set()).update(rules)
        if tok.line.strip().startswith("#"):     # standalone comment
            out.setdefault(line + 1, set()).update(rules)
    return out


# -- file collection --------------------------------------------------------

def collect_files(paths: Iterable[str],
                  root: str | None = None) -> list[tuple[str, str]]:
    """Expand path arguments into ``(abspath, display)`` pairs.

    Directories are walked recursively for ``*.py``; display paths are
    posix-style and relative to `root` (default: cwd) so findings and
    baseline entries are machine independent.
    """
    root = os.path.abspath(root or os.getcwd())
    seen: set[str] = set()
    out: list[tuple[str, str]] = []

    def add(abspath: str) -> None:
        abspath = os.path.abspath(abspath)
        if abspath in seen:
            return
        seen.add(abspath)
        rel = os.path.relpath(abspath, root).replace(os.sep, "/")
        out.append((abspath, rel))

    for p in paths:
        p = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in _SKIP_DIRS
                                     and not d.startswith("."))
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        add(os.path.join(dirpath, fn))
        elif p.endswith(".py") and os.path.isfile(p):
            add(p)
    return sorted(out, key=lambda t: t[1])


# -- baseline ---------------------------------------------------------------

def baseline_key(f: Finding) -> str:
    return f"{f.path}::{f.rule}::{f.message}"


def load_baseline(path: str) -> set[str]:
    if not os.path.isfile(path):
        return set()
    out: set[str] = set()
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line and not line.startswith("#"):
                out.add(line)
    return out


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    keys = sorted({baseline_key(f) for f in findings})
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("# lint baseline: one `path::rule::message` per "
                 "line; see README 'Static analysis'.\n")
        for k in keys:
            fh.write(k + "\n")


# -- runner -----------------------------------------------------------------

def run(paths: Iterable[str], root: str | None = None,
        rules: Iterable[str] | None = None,
        profile: dict[str, float] | None = None,
        ) -> tuple[list[Finding], Project]:
    """Parse every file once, run the checkers, return raw findings
    (suppressions and baseline NOT yet applied) plus the project.

    Per-module rules see each ``Module``; ``ProjectChecker`` rules
    additionally get the resolved ``CallGraph`` (built once, only
    when such a rule is selected).  Pass a dict as ``profile`` to get
    per-rule wall seconds (plus ``[parse]`` / ``[callgraph]``).
    """
    findings: list[Finding] = []
    modules: list[Module] = []
    t0 = time.perf_counter()
    for abspath, display in collect_files(paths, root):
        try:
            modules.append(Module.parse(abspath, display))
        except SyntaxError as e:
            findings.append(Finding(display, e.lineno or 1, "parse",
                                    f"syntax error: {e.msg}"))
    project = Project(modules)
    if profile is not None:
        profile["[parse]"] = time.perf_counter() - t0
    checkers = get_checkers(rules)
    if any(isinstance(c, ProjectChecker) for c in checkers):
        t0 = time.perf_counter()
        project.graph()
        if profile is not None:
            profile["[callgraph]"] = time.perf_counter() - t0
    for checker in checkers:
        t0 = time.perf_counter()
        for mod in project.modules:
            if checker.scope(mod):
                findings.extend(checker.check(mod))
        findings.extend(checker.finalize(project))
        if isinstance(checker, ProjectChecker):
            findings.extend(checker.check_project(project.graph()))
        if profile is not None:
            profile[checker.name] = (profile.get(checker.name, 0.0)
                                     + time.perf_counter() - t0)
    return sorted(findings), project


def changed_closure(project: Project, dirty: Iterable[str],
                    max_fanout: int = 8) -> set[str]:
    """Expand a set of dirty file paths with every module holding a
    (transitive) caller of anything the dirty modules define -- the
    re-analysis set for ``lint.py --changed``: an edit to a callee can
    surface interprocedural findings in callers that did not change.
    """
    graph = project.graph()
    dirty = set(dirty)
    targets = [q for q, fi in graph.functions.items()
               if fi.path in dirty]
    targets += [graph.module_root(p) for p in dirty
                if p in graph.symbols]
    out = set(dirty)
    for qual in graph.callers(targets, max_fanout=max_fanout):
        fi = graph.functions.get(qual)
        if fi is not None:
            out.add(fi.path)
    return out


def filter_suppressed(findings: Iterable[Finding], project: Project,
                      baseline: set[str] | None = None,
                      ) -> tuple[list[Finding], int, int]:
    """Apply inline suppressions then the baseline.

    Returns (kept, n_inline_suppressed, n_baselined).
    """
    baseline = baseline or set()
    by_path = project.by_path()
    kept: list[Finding] = []
    n_inline = n_base = 0
    for f in findings:
        mod = by_path.get(f.path)
        if mod is not None and mod.suppressed(f):
            n_inline += 1
        elif baseline_key(f) in baseline:
            n_base += 1
        else:
            kept.append(f)
    return kept, n_inline, n_base
