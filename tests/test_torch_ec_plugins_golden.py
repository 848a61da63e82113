"""Golden byte-parity fixtures: committed encode vectors every plugin
must reproduce exactly, forever (the ceph-erasure-code-corpus /
non_regression discipline, src/test/erasure-code/
ceph_erasure_code_non_regression.cc).  A failure here means an
encoding-breaking change: bytes already on disk in deployed clusters
would no longer decode identically.

The port's counterpart of ``tests/test_golden.py``: the committed vectors
(``tests/fixtures/ec_golden.npz``) through ``ceph_tpu_torch``'s plugins; the
``tpu`` plugin's case runs the port's ``cuda`` plugin on the CPU.
"""

import pathlib

import numpy as np
import pytest

from torch_ec_plugin_cases import CpuRegistry as ErasureCodePluginRegistry

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "ec_golden.npz"


def load_cases():
    data = np.load(FIXTURE)
    cases = {}
    for key in data.files:
        case, _, part = key.partition("||")
        cases.setdefault(case, {})[part] = data[key]
    return cases


def parse_case(name: str):
    _, plugin, prof = name.split("|")
    profile = dict(kv.split("=", 1) for kv in prof.split(","))
    return plugin, profile


CASES = load_cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_golden_encode_parity(case):
    plugin, profile = parse_case(case)
    parts = CASES[case]
    codec = ErasureCodePluginRegistry().factory(plugin, profile)
    n = codec.get_chunk_count()
    chunks = codec.encode(set(range(n)), parts["data"].tobytes())
    for shard in range(n):
        want = parts[f"shard{shard:02d}"]
        assert np.array_equal(chunks[shard], want), \
            f"{case}: shard {shard} bytes diverged from golden fixture"


@pytest.mark.parametrize("case", sorted(CASES))
def test_golden_decode_every_single_erasure(case):
    """Every single-shard erasure decodes back to the EXACT fixture
    bytes (the benchmark's exhaustive verification mode,
    ceph_erasure_code_benchmark.cc:234-244)."""
    plugin, profile = parse_case(case)
    parts = CASES[case]
    codec = ErasureCodePluginRegistry().factory(plugin, profile)
    n = codec.get_chunk_count()
    chunks = {s: parts[f"shard{s:02d}"] for s in range(n)}
    for lost in range(n):
        have = {s: c for s, c in chunks.items() if s != lost}
        dec = codec.decode({lost}, have)
        assert np.array_equal(dec[lost], chunks[lost]), (case, lost)


@pytest.mark.parametrize("case", [
    c for c in sorted(CASES)
    if parse_case(c)[0] == "isa"
    and parse_case(c)[1].get("technique") in ("reed_sol_van", "cauchy")])
def test_golden_cuda_plugin_matches(case):
    """The card's plugin (here its plain versions) reproduces the same bytes as the isa
    fixtures (it implements ISA-L matrix semantics; jerasure's
    reed_sol_van systematizes differently by design)."""
    _, profile = parse_case(case)
    parts = CASES[case]
    codec = ErasureCodePluginRegistry().factory(
        "cuda", {"k": profile["k"], "m": profile["m"],
                "technique": profile["technique"]})
    n = codec.get_chunk_count()
    chunks = codec.encode(set(range(n)), parts["data"].tobytes())
    for shard in range(n):
        assert np.array_equal(chunks[shard],
                              parts[f"shard{shard:02d}"]), shard
