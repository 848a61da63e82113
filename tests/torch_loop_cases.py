"""The reference's ``run_workload`` under the port's loop sampler, at the
shape and heartbeats ``ceph_tpu_torch.tools.loop_sampler`` takes, on the
CPU: the witness that a behaviour of the one-loop cluster (false
mark-downs after a kill, wedged ops) is the reference's too.

    JAX_PLATFORMS=cpu python tests/torch_loop_cases.py --objects 1000 \\
        --ops 1000 --recovery-ops 300 [--heartbeat 6 20]

prints the sampler's JSON object for the reference (no K5 counts: the
reference launches none).  Its vectorized CRUSH imports
``jax.experimental.enable_x64``, which jax 0.9 lacks; the script sets it
to ``jax.enable_x64`` for its own process, as ``test_torch_crush``'s
loader does while it loads that module.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax                                                     # noqa: E402
import jax.experimental                                        # noqa: E402

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

from ceph_tpu.loadgen import run_workload as ref_run_workload  # noqa: E402
from ceph_tpu.loadgen import WorkloadSpec as RefSpec           # noqa: E402
from ceph_tpu_torch.tools import loop_sampler                  # noqa: E402


def reference_workload(spec, *, log, device, on_stage):
    """The reference's run on the same spec; it reports no stages."""
    return ref_run_workload(RefSpec(**spec.to_dict()).validate(), log=log)


def main(argv=None) -> int:
    args = loop_sampler.build_parser().parse_args(argv)
    res = loop_sampler.run(args, workload=reference_workload)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
