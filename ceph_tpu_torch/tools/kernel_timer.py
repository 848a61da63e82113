"""What the per-kernel timers (``k1_time.py``, ``k3_time.py``, ``k4_time.py``,
``k5_time.py``) share: ``--set`` knobs and the variant they build, CUDA-event
readings, the card's name and power limit, ptxas's counts from a build log,
and a kernel's SASS counted by issue pipe.

A timer imports the ``ceph_tpu_torch`` of the checkout its ``--root`` names,
so this module imports nothing of the package at its top, and what it parses
with comes from the ``_build`` beside it, whatever tree is timed.  A timer
run as a script imports it as the module beside it.
"""

from __future__ import annotations

import collections
import functools
import importlib.util
import re
import subprocess
from pathlib import Path


def knobs(specs: list[str]) -> dict[str, int]:
    """``["A=1,B=2", "C=3"]`` -> ``{"A": 1, "B": 2, "C": 3}``."""
    return {k: int(v) for spec in specs for k, v in
            (kv.split("=", 1) for kv in spec.split(","))}


def use_variant(build, module, source: str, name: str,
                values: dict[str, int]) -> None:
    """Make ``module`` (a wrapper with ``_load``) launch its kernel from a
    copy of ``csrc/source`` with those ``constexpr int`` knobs set, built by
    the timed tree's ``build`` as ``name``."""
    from ceph_tpu_torch.tools.k2_sweep import variant_text
    build.add_generated(name, variant_text((build.CSRC / source).read_text(),
                                           values))
    module._lib = functools.lru_cache(maxsize=1)(lambda: module._load(name))


def readings(fn, iters: int, repeats: int) -> list[float]:
    """``repeats`` CUDA-event means of ``iters`` calls of ``fn``, in ms,
    after one warm call."""
    import torch
    fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return runs


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=1)
def own_build():
    """The ``ops/_build.py`` of this file's checkout."""
    spec = importlib.util.spec_from_file_location(
        "_kernel_timer_build",
        Path(__file__).resolve().parents[1] / "ops" / "_build.py")
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    return build


def ptxas(log: str) -> dict:
    """ptxas's registers, shared memory, stack and spill bytes in an nvcc
    ``-Xptxas -v`` log ({} for no log)."""
    if not log:
        return {}
    counts = own_build().ptxas_counts(log)
    return {key: counts[key] for key in ("registers", "smem", "stack",
                                         "spill_stores", "spill_loads")}


# SASS opcode -> issue pipe (Hopper); what is not listed counts as "other"
_PIPES = {
    "alu": ("IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "IMNMX", "VIMNMX",
            "PRMT", "BMSK", "SGXT", "PLOP3", "IABS", "FSEL", "FSETP", "CSETP"),
    "fma": ("IMAD", "IMUL", "FFMA", "FMUL", "FADD", "HFMA2", "HADD2", "HMUL2",
            "IDP", "IMMA"),
    "fp64": ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX"),
    "conversion": ("I2F", "F2I", "F2F", "I2I", "MUFU", "FRND", "I2IP", "F2FP",
                   "FLO", "POPC", "BREV"),
    "memory": ("LDS", "LDG", "LDL", "LDC", "LD", "STS", "STG", "STL", "ST",
               "ATOM", "ATOMS", "ATOMG", "RED", "LDSM", "LDGSTS"),
    "control": ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "BAR",
                "WARPSYNC", "YIELD", "NOP", "BREAK", "JMP", "BPT", "KILL",
                "BMOV", "WARPGROUP"),
    "move": ("MOV", "S2R", "S2UR", "CS2R", "P2R", "R2P", "VOTE", "SHFL",
             "R2UR"),
}
_PIPE_OF = {op: pipe for pipe, ops in _PIPES.items() for op in ops}


def pipe(op: str) -> str:
    """The issue pipe of a SASS opcode (its modifiers ignored)."""
    base = op.split(".")[0]
    if base in _PIPE_OF:
        return _PIPE_OF[base]
    return "uniform" if base.startswith("U") else "other"


def sass(lib_path: Path, nvcc: str) -> str | None:
    """``cuobjdump -sass`` of a built library, where the toolkit has it."""
    tool = Path(nvcc).parent / "cuobjdump"
    if not tool.exists():
        return None
    proc = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300)
    return proc.stdout if proc.returncode == 0 else None


def parse_sass(text: str) -> list[tuple[int, str, str, list[str]]]:
    """(address, opcode, whole text, labels at this address) of each
    instruction of ``cuobjdump -sass`` output."""
    out, labels = [], []
    for line in text.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+|\.L_\w+|\$[\w$.]+):\s*$", line)
        if lab:
            labels.append(lab.group(1))
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;", line)
        if not ins:
            continue
        body = ins.group(2).strip()
        op = re.sub(r"^@!?U?P[T0-9]+\s+", "", body).split()[0]
        out.append((int(ins.group(1), 16), op, body, labels))
        labels = []
    return out


class Sass:
    """Parsed SASS: counts by pipe over a range, innermost loops, the
    routines a range calls."""

    def __init__(self, text: str):
        self.ins = parse_sass(text)
        self.label_addr = {lab: a for a, _, _, labs in self.ins for lab in labs}
        self.index = {a: i for i, (a, _, _, _) in enumerate(self.ins)}

    def count(self, lo: int, hi: int) -> dict:
        """Instructions lo..hi (indices, inclusive) by pipe and opcode."""
        ops = collections.Counter(self.ins[i][1].split(".")[0]
                                  for i in range(lo, hi + 1))
        pipes = collections.Counter()
        for op, n in ops.items():
            pipes[pipe(op)] += n
        return {"instructions": sum(ops.values()), "by_pipe": dict(pipes),
                "by_opcode": dict(ops.most_common())}

    def kernel(self) -> dict:
        return self.count(0, len(self.ins) - 1) if self.ins else {}

    def _target(self, body: str) -> int | None:
        m = re.search(r"`\(([^)]+)\)", body)
        if m:
            return self.label_addr.get(m.group(1))
        m = re.search(r"\b0x([0-9a-f]+)\b", body.split(None, 1)[-1])
        return int(m.group(1), 16) if m else None

    def innermost_loops(self) -> list[tuple[int, int]]:
        """(first, last) indices of each backward branch's loop that holds
        no other."""
        loops = []
        for i, (a, op, body, _) in enumerate(self.ins):
            if op.startswith("BRA"):
                t = self._target(body)
                if t is not None and t <= a and t in self.index:
                    loops.append((self.index[t], i))
        return sorted({(s, e) for s, e in loops
                       if not any((s2, e2) != (s, e) and s <= s2 and e2 <= e
                                  for s2, e2 in loops)})

    def calls(self, lo: int, hi: int) -> list[dict]:
        """Each routine that instructions lo..hi call: its size and pipes."""
        out = []
        for i in range(lo, hi + 1):
            if self.ins[i][1].startswith("CALL"):
                j = self.index.get(self._target(self.ins[i][2]))
                if j is not None:
                    k = next((k for k in range(j, len(self.ins))
                              if self.ins[k][1].startswith("RET")),
                             len(self.ins) - 1)
                    out.append({"at": hex(self.ins[i][0]),
                                "instructions": k - j + 1,
                                "by_pipe": self.count(j, k)["by_pipe"]})
        return out
