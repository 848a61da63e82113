"""dropped-task: fire-and-forget asyncio tasks must not die silently.

A bare ``asyncio.create_task(...)`` / ``ensure_future(...)`` statement
drops the Task object on the floor: its exception is never retrieved
(the failure surfaces, at best, as a "Task exception was never
retrieved" stderr line long after the fact) and CPython keeps only a
weak reference to running tasks, so the garbage collector may cancel
it mid-flight.  Every daemon loop here learned this the hard way --
the OSD/mgr/monitor all route spawns through ``make_task_tracker`` or
keep the handle on ``self``.

Compliant forms: assign the result (to a name, attribute, or through
a tracker like ``self._track(...)``), await it, or chain an immediate
``.add_done_callback(...)``.

Beyond the raw asyncio spawners, TASK_ROOTS names project APIs that
RETURN a live task the caller must own -- ``OSD.start_request`` hands
back ``(tid, task)`` and the HedgedGather engine is the one place
that cancels AND reaps those sub-reads; a bare ``start_request(...)``
statement is a sub-read nobody will ever cancel, whose late reply
nobody will ever drain.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .. import astutil
from ..core import Finding, Module
from ..registry import Checker, register

_SPAWNERS = {"create_task", "ensure_future"}

# task-returning project APIs: the result carries a live task (or
# reply waiters) the caller owns.  start_request: dropping the tuple
# orphans the sub-read task (HedgedGather is the intended owner).
# fanout_staged: the returned (tid, future) waiters ARE the commit
# acks of the pipelined write spine -- a bare call stages sends whose
# replies nobody ever drains (wedged waiters).  arm_flush_window: the
# sub-op pipe's flush-window coroutine; unowned, the staged flush
# never ships.
TASK_ROOTS = {"start_request", "fanout_staged", "arm_flush_window"}


@register
class DroppedTask(Checker):
    name = "dropped-task"
    description = ("asyncio create_task/ensure_future result dropped "
                   "without a done-callback (silent task death)")

    def check(self, module: Module) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Expr)
                    and isinstance(node.value, ast.Call)):
                continue
            leaf = astutil.name_leaf(node.value.func)
            if leaf in _SPAWNERS:
                yield Finding(
                    module.path, node.lineno, self.name,
                    f"{leaf}() result dropped: the task's exception is "
                    f"never retrieved and the GC may cancel it "
                    f"mid-flight; keep a reference (tracker/attribute) "
                    f"or attach a done-callback")
            elif leaf in TASK_ROOTS:
                yield Finding(
                    module.path, node.lineno, self.name,
                    f"{leaf}() result dropped: it returns a live "
                    f"sub-read task the caller owns -- unowned, it is "
                    f"never cancelled or reaped and its late reply is "
                    f"never drained (the HedgedGather engine is the "
                    f"intended owner on the read spine)")
