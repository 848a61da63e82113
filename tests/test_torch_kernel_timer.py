"""The kernel timers' shared helpers (``ceph_tpu_torch/tools/kernel_timer.py``)
on the CPU: knob parsing, the issue pipe of a SASS opcode, and the SASS
counter's loops and calls on a small listing in ``cuobjdump -sass``'s
format (``test_torch_k5_host.py`` holds K5's draw count on another)."""

import pytest

from ceph_tpu_torch.tools import kernel_timer as kt


def _line(addr: int, text: str) -> str:
    return (f"        /*{addr:04x}*/                   {text} ;"
            f"                          /* 0x0000000000000000 */")


def _listing(body: list[str]) -> str:
    """``body``'s instructions at addresses 0x10 apart, each followed by
    the encoding's second line, as cuobjdump prints them."""
    out = []
    for i, text in enumerate(body):
        out += [_line(16 * i, text),
                "                                        /* 0x000fe2 */"]
    return "\n".join(out)


def test_knobs_parse_every_spec():
    assert kt.knobs(["kA=1,kB=-2", "kC=30"]) == {"kA": 1, "kB": -2, "kC": 30}
    assert kt.knobs([]) == {}


@pytest.mark.parametrize("op, pipe", [
    ("LOP3.LUT", "alu"), ("SHF.R.U32.HI", "alu"), ("IADD3", "alu"),
    ("IMAD.WIDE.U32", "fma"), ("IMAD.HI.U32", "fma"), ("DFMA", "fp64"),
    ("MUFU.RCP", "conversion"), ("LDS.64", "memory"), ("CALL.REL.NOINC",
                                                        "control"),
    ("UIADD3", "uniform"), ("XYZ", "other")])
def test_pipe_of_an_opcode(op, pipe):
    assert kt.pipe(op) == pipe


def test_sass_finds_the_innermost_loop_and_its_call():
    # 0x00 MOV; loop 0x10..0x40 (inner 0x20..0x30) branching back; a call
    # at 0x50 to a 3-instruction routine at 0x70
    body = ["MOV R1, RZ", "IADD3 R2, R2, 0x1, RZ", "LOP3.LUT R3, R3, R2, RZ, 0x3c, !PT",
            "@P0 BRA 0x20", "@P1 BRA 0x10", "CALL.REL.NOINC 0x70", "EXIT",
            "IMAD R4, R4, R4, RZ", "SHF.R.U32.HI R4, RZ, 0x3, R4", "RET.REL.NODEC R20 0x0"]
    sass = kt.Sass(_listing(body))
    assert sass.kernel()["instructions"] == len(body)
    assert sass.innermost_loops() == [(2, 3)]
    inner = sass.count(2, 3)
    assert inner["by_pipe"] == {"alu": 1, "control": 1}
    calls = sass.calls(0, 6)
    assert [(c["at"], c["instructions"]) for c in calls] == [("0x50", 3)]
    assert calls[0]["by_pipe"] == {"fma": 1, "alu": 1, "control": 1}

