"""Machine-readable process-seam audit (``SEAM_AUDIT.json``).

The swarm PR will replace SimCluster's in-process daemons with real
processes; every assumption that only holds because the daemons share
one interpreter becomes a silent corruption the day they stop.  This
module composes the pure-data census passes the three seam rules
already run -- shared mutable state (cross-daemon-state), the wire
vocabulary (wire-safety), and await-window snapshot races
(await-invalidates-snapshot) -- into one artifact that the swarm PR
can diff against:

* ``shared_state``   -- every module-level mutable global and mutable
  class attribute, classified fork-safe recomputable cache vs
  per-process counter/primitive vs correctness state;
* ``daemon_reaches`` -- every site where one daemon touches another's
  private or subsystem attributes instead of crossing the Messenger,
  with the inline justification when one is carried;
* ``wire_types``     -- every message type with its codec class,
  payload-safety verdict, and whether any dispatcher consumes it;
* ``snapshot_races`` -- every bind -> await -> use window, with its
  justification when suppressed.

Entries whose flagged line carries a ``# lint: disable=<rule> -- why``
directive are marked ``justified`` and the ``why`` text is lifted into
the report, so the artifact names each sharp edge *and* the reason it
is allowed to stay.  CLI front end: ``python -m ceph_tpu_torch.tools.lint
--seam-report PATH``.
"""

from __future__ import annotations

from .core import Module, Project
from .checkers.await_snapshot import snapshot_races
from .checkers.cross_daemon_state import daemon_reaches, shared_state_census
from .checkers.wire_safety import wire_census

SCHEMA = "ceph-tpu-seam-audit-v1"

# the analyzer's own tables (rule registries, hint tuples) are not
# cluster state; keeping them out leaves the audit about the daemons
_SELF_PATHS = ("analysis/",)


def _justification(mod: Module | None, line: int,
                   rule: str) -> str | None:
    """The ``-- why`` text of the disable directive covering ``line``
    (the directive's own line or the standalone comment line above),
    or None when the site is not suppressed for ``rule``."""
    if mod is None:
        return None
    rules = mod.suppressions.get(line, set())
    if "*" not in rules and rule not in rules:
        return None
    lines = mod.source.splitlines()
    for ln in (line, line - 1):
        if not 1 <= ln <= len(lines):
            continue
        text = lines[ln - 1]
        if "lint:" in text and "disable" in text and "--" in text:
            return text.split("--", 1)[1].strip()
    return ""


def build_report(project: Project) -> dict:
    """The full seam audit as a JSON-serializable dict."""
    graph = project.graph()
    mods = project.by_path()

    shared = [e for e in shared_state_census(graph)
              if not any(p in e["path"] for p in _SELF_PATHS)]

    reaches = []
    for r in daemon_reaches(graph):
        why = _justification(mods.get(r["path"]), r["line"],
                             "cross-daemon-state")
        reaches.append({**r, "justified": why is not None,
                        "justification": why})

    wire = []
    for e in wire_census(graph):
        why = None
        for site in e["sites"]:
            path, _, line = site.rpartition(":")
            why = _justification(mods.get(path), int(line),
                                 "wire-safety")
            if why is not None:
                break
        wire.append({**e, "justified": why is not None,
                     "justification": why})

    races = []
    for r in snapshot_races(graph):
        why = _justification(mods.get(r["path"]), r["line"],
                             "await-invalidates-snapshot")
        races.append({**r, "justified": why is not None,
                      "justification": why})

    by_class: dict[str, int] = {}
    for e in shared:
        c = e["classification"]
        by_class[c] = by_class.get(c, 0) + 1

    summary = {
        "shared_state_sites": len(shared),
        "shared_state_by_classification": dict(sorted(
            by_class.items())),
        "daemon_reaches": len(reaches),
        "unjustified_daemon_reaches": sum(
            1 for r in reaches if not r["justified"]),
        "wire_types": len(wire),
        "unsafe_wire_types": sorted(
            e["type"] for e in wire if e["verdict"] != "wire-safe"),
        "unhandled_wire_types": sorted(
            e["type"] for e in wire
            if not e["handled"] and not e["justified"]),
        "snapshot_races": len(races),
        "unjustified_snapshot_races": sum(
            1 for r in races if not r["justified"]),
    }
    return {
        "version": 1,
        "schema": SCHEMA,
        "shared_state": shared,
        "daemon_reaches": reaches,
        "wire_types": wire,
        "snapshot_races": races,
        "summary": summary,
    }
