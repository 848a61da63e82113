"""Pluggable checker registry.

A rule is a ``Checker`` subclass registered with ``@register``; the
runner in ``core`` parses each file once and hands the shared
``Module`` objects to every registered checker -- ``check()`` per
module in scope, then ``finalize()`` once with the whole project for
cross-module passes (e.g. perf-counter coherence).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterable

if TYPE_CHECKING:                         # pragma: no cover
    from .callgraph import CallGraph
    from .core import Finding, Module, Project


class Checker:
    """Base class for one rule.

    ``name`` is the rule id used in findings, ``# lint: disable=`` and
    ``--rules``; ``description`` is one line for ``--list-rules``.
    """

    name: str = ""
    description: str = ""

    def scope(self, module: "Module") -> bool:
        """Whether `module` is subject to this rule (default: all)."""
        return True

    def check(self, module: "Module") -> Iterable["Finding"]:
        """Per-module pass over one parsed file."""
        return ()

    def finalize(self, project: "Project") -> Iterable["Finding"]:
        """Cross-module pass, called once after every check()."""
        return ()


class ProjectChecker(Checker):
    """Base class for whole-program rules.

    Besides the per-module hooks, a ProjectChecker receives the
    resolved ``CallGraph`` (symbol table, call/reference edges with
    fan-out, lock regions, reachability queries) once per run.  The
    graph is built lazily: it only costs anything when at least one
    registered ProjectChecker is selected.
    """

    def check_project(self,
                      graph: "CallGraph") -> Iterable["Finding"]:
        """Whole-program pass over the resolved call graph."""
        return ()


_REGISTRY: dict[str, Checker] = {}
# rules of the reference that the port does not carry, with the reason
_OMITTED: dict[str, str] = {}


def register(cls: type[Checker]) -> type[Checker]:
    """Class decorator: instantiate and register a checker by name."""
    if not cls.name:
        raise ValueError(f"checker {cls.__name__} has no name")
    if cls.name in _REGISTRY:
        raise ValueError(f"duplicate checker name {cls.name!r}")
    _REGISTRY[cls.name] = cls()
    return cls


def get_checkers(names: Iterable[str] | None = None) -> list[Checker]:
    """All registered checkers, or the named subset (order stable)."""
    if names is None:
        return [_REGISTRY[k] for k in sorted(_REGISTRY)]
    out = []
    for n in names:
        if n not in _REGISTRY:
            known = ", ".join(sorted(_REGISTRY))
            raise KeyError(f"unknown rule {n!r} (known: {known})")
        out.append(_REGISTRY[n])
    return out


def omit(name: str, reason: str) -> None:
    """Record a reference rule the port leaves out, and why."""
    if name in _REGISTRY or name in _OMITTED:
        raise ValueError(f"duplicate checker name {name!r}")
    _OMITTED[name] = reason


def omitted() -> dict[str, str]:
    """The omitted rules by name, each with its reason."""
    return dict(sorted(_OMITTED.items()))
