"""Project-native static analysis of the port.

Port of ``ceph_tpu/analysis``: the same framework and layout.  The
reference's bug classes were mechanically detectable invariant
violations -- raw ``CRUSH_ITEM_NONE`` leaking into ``o >= 0`` role
checks, a process-wide dtype switch flipped at import time, host syncs
and rebuilds on the launch paths -- and this package encodes them as AST
checkers so tooling, not vigilance, enforces them.  The rules
that guarded JAX are rewritten for torch, or recorded as omitted with
their reason (``registry.omitted``).

Layout:

* ``core``      -- file collection, single-parse module model, inline
                   ``# lint: disable=<rule>`` suppressions, baseline
                   files, and the run orchestration.
* ``registry``  -- the pluggable checker registry (``@register``) and
                   the omitted rules (``omit``).
* ``checkers``  -- the project rules; importing the subpackage
                   registers them.

CLI front end: ``python -m ceph_tpu_torch.tools.lint`` (see README
"Static analysis of the port").
"""

from .core import (          # noqa: F401
    Finding,
    Module,
    Project,
    baseline_key,
    changed_closure,
    collect_files,
    filter_suppressed,
    load_baseline,
    run,
    write_baseline,
)
from .registry import (      # noqa: F401
    Checker,
    ProjectChecker,
    get_checkers,
    omit,
    omitted,
    register,
)

# Importing the subpackage registers every built-in rule.
from . import checkers       # noqa: F401,E402
