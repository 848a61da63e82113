"""The port's entry points (``ceph_tpu_torch.graft_entry``) against the
repository root's ``__graft_entry__`` on the CPU.

``entry(device="cpu")`` computes the reference ``entry()``'s encode on the
same example, byte for byte; without a card ``entry()`` raises.
``dryrun_multichip(8, device="cpu")`` runs on 8 gloo ranks and prints the
reference's four "ok" lines, with the reference's mesh shapes and sizes;
on the card it refuses more ranks than cards.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from ceph_tpu_torch import graft_entry

# what the reference's dryrun_multichip(8) prints on its 8-device mesh
REF_LINES = [
    "dryrun_multichip ok: mesh={'stripe': 4, 'shard': 2} batch=8 recovered "
    "erasures [1, 9] byte-exact",
    "dryrun_multichip lrc ok: mesh={'stripe': 2, 'group': 4} k=12 m=4 l=4; "
    "local repair collective-free",
    "dryrun_multichip rmw ok: 48B partial-stripe write on shard 2, "
    "delta-encoded parity byte-exact",
    "dryrun_multichip cross-recovery ok: erasures [1, 9] rebuilt from "
    "shard-axis-scattered survivors byte-exact",
]


def test_entry_equals_the_reference():
    fn, (example,) = graft_entry.entry(device="cpu")
    ref_fn, (ref_example,) = ref_entry.entry()
    np.testing.assert_array_equal(example.numpy(), np.asarray(ref_example))
    got = fn(example)
    assert got.dtype == torch.uint8 and got.shape == (3, 8192)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_fn(ref_example)))


def test_entry_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()


def test_dryrun_on_eight_gloo_ranks_prints_the_reference_lines(capfd):
    graft_entry.dryrun_multichip(8, device="cpu")
    lines = [ln for ln in capfd.readouterr().out.splitlines()
             if ln.startswith("dryrun_multichip")]
    assert lines == REF_LINES


def test_dryrun_on_the_card_takes_a_card_a_rank(monkeypatch):
    monkeypatch.setattr(graft_entry, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="a card a rank"):
        graft_entry.dryrun_multichip(4)
