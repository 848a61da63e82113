"""Generate the CUDA source of kernel K3 (``xor_sched``) for one schedule.

Each compiled ``XorSchedule`` becomes one source for ``csrc/xor_sched.cuh``'s
kernel with the XORs written out as code, so every value lives in a
register.  The entry ``xor_sched_<digest>`` has the calling convention of
K1/K2 (data, out, B, k, r, L, device, stream) and returns
``cudaGetLastError()``.

``design_for`` picks one of two designs per schedule, from its shape alone:

  * ``register`` -- the schedule's own SSA XORs (its CSE temporaries
    included), with all 8k input planes loaded and live for the whole
    schedule; an output row is packed and stored right after the op that
    completes its last plane.  The least XORs, and every row's loads in
    flight at once, but 8k planes plus the temporaries must fit the
    register file: the smallest k only.
  * ``tiled`` -- the bit-matrix rows the schedule expands to, evaluated in
    tiles of output rows.  A tile's accumulators stay in registers while the
    input rows stream past in input-major order: each input row's 8 planes
    are read once per tile and folded into every accumulator that needs
    them, through the XORs of each nibble of planes that the tile uses (a
    four-Russians table: one 3-input XOR per accumulator and input row).
    Live values are the tile's accumulators, one row's planes and its
    tables, whatever k is.  A tile is a runtime loop over the input rows
    (load and transpose the row, then a switch on the row to its XORs) and
    one over its output rows: the compiler can then neither hoist every
    row's loads ahead of the XORs nor grow the code past the instruction
    cache.  Past one tile (more than ``TILE_MAX_PLANES`` output planes),
    each tile loads the input rows again.
"""

from __future__ import annotations

from dataclasses import dataclass

from .xor_schedule import XorSchedule

HEADER = "xor_sched.cuh"

# the register design while 8k input planes are at most this many (on the
# H100 it won at 24 and 32 planes, was 1-2% ahead at 48, level at 40 and 56
# and lost at 64: PERF.md)
REGISTER_MAX_IN_PLANES = 48
# output planes a tile of the tiled design holds at most (whole rows)
TILE_MAX_PLANES = 128
# live 32-bit values a thread may hold; the live estimate of every design
# design_for picks stays within it
REGISTER_BUDGET = 200
# the tiled design's live values beside its accumulators: one input row's 8
# planes, the next row's 8 loaded words, up to 22 nibble XORs, addresses
_TILED_OVERHEAD = 8 + 8 + 22 + 12
# the register design's beside its inputs and temporaries
_REGISTER_OVERHEAD = 16


def register_cap(threads: int, min_blocks: int) -> int:
    """The registers a thread may use under ``__launch_bounds__(threads,
    min_blocks)``: each of a SM's 4 schedulers has 16384, its share of the
    warps round up, in steps of 8, at most 255."""
    warps = -(-threads // 32) * min_blocks
    return min(255, 16384 // (-(-warps // 4) * 32) // 8 * 8)


@dataclass(frozen=True)
class Design:
    """How K3's source evaluates one schedule.

    ``tiles`` holds the output rows of each tile (tiled design; every output
    row in exactly one tile, in order), ``threads`` the block size and
    ``min_blocks`` the blocks a SM that ``__launch_bounds__`` asks registers
    for."""

    kind: str                                  # "register" or "tiled"
    tiles: tuple[tuple[int, ...], ...] = ()
    threads: int = 128
    min_blocks: int = 1

    @property
    def tag(self) -> str:
        if self.kind == "register":
            return f"reg_t{self.threads}b{self.min_blocks}"
        width = max(len(t) for t in self.tiles)
        return (f"tile{width}x{len(self.tiles)}"
                f"_t{self.threads}b{self.min_blocks}")

    def live_estimate(self, sched: XorSchedule) -> int:
        """32-bit values live at once in a thread, by the design's count."""
        if self.kind == "register":
            return sched.n_in + sched.peak_registers + _REGISTER_OVERHEAD
        return 8 * max(len(t) for t in self.tiles) + _TILED_OVERHEAD


def tile_plan(n_rows: int, max_rows: int) -> tuple[tuple[int, ...], ...]:
    """Output rows 0..n_rows-1 in the fewest tiles of at most ``max_rows``
    rows, as even as they go (earlier tiles one row larger)."""
    n_tiles = max(1, -(-n_rows // max_rows))
    base, extra = divmod(n_rows, n_tiles)
    tiles, row = [], 0
    for t in range(n_tiles):
        size = base + (t < extra)
        tiles.append(tuple(range(row, row + size)))
        row += size
    return tuple(tiles)


def design_for(sched: XorSchedule, *, kind: str | None = None,
               tile_planes: int = TILE_MAX_PLANES) -> Design:
    """The design K3 builds for ``sched``: a pure function of its shape.

    The register design while its input planes are few enough and its live
    estimate fits ``REGISTER_BUDGET``, else the tiled one.  ``kind`` and the
    planes a tile holds at most override the choice, for the tools and
    tests that build another design with ``generate``."""
    register = Design("register")
    if kind is None:
        small = sched.n_in <= REGISTER_MAX_IN_PLANES and \
            register.live_estimate(sched) <= REGISTER_BUDGET
        kind = "register" if small else "tiled"
    if kind == "register":
        return register
    if kind != "tiled":
        raise ValueError(f"unknown K3 design {kind!r}")
    tiles = tile_plan(sched.n_out // 8, max(1, tile_planes // 8))
    threads = 64
    # the most blocks a SM whose launch bounds leave each thread the budget
    min_blocks = 1
    while register_cap(threads, min_blocks + 1) >= REGISTER_BUDGET:
        min_blocks += 1
    return Design("tiled", tiles, threads, min_blocks)


def entry_name(sched: XorSchedule) -> str:
    return f"xor_sched_{sched.digest}"


def source_name(sched: XorSchedule, design: Design | None = None) -> str:
    """The builder's name of the source: the entry's, and the design's tag
    for a design other than the default."""
    name = entry_name(sched)
    return name if design is None else f"{name}_{design.tag}"


def _value(v: int, n_in: int) -> str:
    if v < 0:
        return "0u"                    # an all-zero output row
    return f"x{v}" if v < n_in else f"v{v}"


def _register_body(sched: XorSchedule) -> list[str]:
    n_in = sched.n_in
    k, r = n_in // 8, sched.n_out // 8
    # output rows by the op after which all 8 of their planes exist
    ready: dict[int, list[int]] = {}
    for i in range(r):
        ids = sched.outputs[8 * i:8 * i + 8]
        last = max((v - n_in for v in ids if v >= n_in), default=-1)
        ready.setdefault(last, []).append(i)

    def stores(idx: int) -> list[str]:
        out = []
        for i in ready.get(idx, ()):
            planes = ", ".join(_value(v, n_in)
                               for v in sched.outputs[8 * i:8 * i + 8])
            out.append(f"    {{ const uint32_t o[8] = {{{planes}}}; "
                       f"io.store({i}, o); }}")
        return out

    body = [f"    uint32_t {', '.join(f'x{v}' for v in range(n_in))};"]
    for j in range(k):
        names = " ".join(f"x{8 * j + s} = p[{s}];" for s in range(8))
        body.append(f"    {{ uint32_t p[8]; io.load({j}, p); {names} }}")
    body += stores(-1)
    for idx, (a, b) in enumerate(sched.ops):
        body.append(f"    const uint32_t v{n_in + idx} = "
                    f"{_value(a, n_in)} ^ {_value(b, n_in)};")
        body += stores(idx)
    return body


def plane_rows(sched: XorSchedule) -> list[int]:
    """Each output plane's set of input planes (bit p = input plane p): the
    bit-matrix row the schedule computes, found by expanding its ops."""
    val = [1 << p for p in range(sched.n_in)]
    for a, b in sched.ops:
        val.append(val[a] ^ val[b])
    return [0 if o < 0 else val[o] for o in sched.outputs]


def _nibble(mask: int, base: int, name: str) -> str:
    """The value of the planes in ``mask`` (4 bits, planes base..base+3)."""
    bits = [s for s in range(4) if mask >> s & 1]
    if len(bits) == 1:
        return f"x[{base + bits[0]}]"
    return f"{name}{mask}"


def _row_case(j: int, masks: dict[int, int], acc: dict[int, str]) -> list[str]:
    """The XORs that fold input row j's planes x[0..7] into the tile's
    accumulators: the nibble XORs the tile uses, then one term per
    accumulator (``masks``: output plane -> its 8-bit mask of row j)."""
    lo = sorted({m & 15 for m in masks.values()} - {0})
    hi = sorted({m >> 4 for m in masks.values()} - {0})
    out = [f"          case {j}: {{"]
    for part, used, base in (("l", lo, 0), ("h", hi, 4)):
        for m in used:
            bits = [s for s in range(4) if m >> s & 1]
            if len(bits) > 1:
                terms = " ^ ".join(f"x[{base + s}]" for s in bits)
                out.append(f"            const uint32_t {part}{m} = {terms};")
    for o, m in masks.items():
        terms = [_nibble(m & 15, 0, "l") if m & 15 else None,
                 _nibble(m >> 4, 4, "h") if m >> 4 else None]
        terms = [t for t in terms if t]
        if terms:
            out.append(f"            {acc[o]} ^= {' ^ '.join(terms)};")
    out.append("          } break;")
    return out


def _tile_body(sched: XorSchedule, rows: tuple[int, ...]) -> list[str]:
    """One tile as two runtime loops: over the input rows (fetch, transpose,
    and a switch on the row to its XORs) and over the tile's output rows (a
    switch on the row to its accumulators, transpose, store).  Loops keep
    the code small and stop the compiler from hoisting every row's loads
    ahead of the XORs; the accumulators stay in registers across them."""
    k = sched.n_in // 8
    planes = [8 * i + t for i in rows for t in range(8)]
    want = plane_rows(sched)
    acc = {o: f"a{n}" for n, o in enumerate(planes)}
    body = [f"    {{  // output rows {rows[0]}-{rows[-1]}",
            "      uint32_t " + ", ".join(f"{acc[o]} = 0u" for o in planes)
            + ";",
            "      uint32_t w[8];",
            "      io.fetch(0, w);",
            "#pragma unroll 1",
            "      for (int j = 0; j < K; ++j) {",
            "        uint32_t x[8];",
            "        xor_sched::bytes_to_planes(w, x);",
            "        if (j + 1 < K) io.fetch(j + 1, w);  // in flight",
            "        switch (j) {"]
    for j in range(k):
        masks = {o: want[o] >> (8 * j) & 0xff for o in planes}
        if any(masks.values()):
            body += _row_case(j, masks, acc)
        # a row no output of the tile reads has no case
    body += ["          default: break;",
             "        }",
             "      }",
             "#pragma unroll 1",
             f"      for (int i = 0; i < {len(rows)}; ++i) {{",
             "        uint32_t o[8];",
             "        switch (i) {"]
    for n, i in enumerate(rows):
        sets = " ".join(f"o[{t}] = {acc[8 * i + t]};" for t in range(8))
        body.append(f"          case {n}: {sets} break;")
    body += ["          default: break;",
             "        }",
             f"        io.store({rows[0]} + i, o);",
             "      }",
             "    }"]
    return body


def generate(sched: XorSchedule, design: Design | None = None) -> str:
    """The CUDA C++ source of K3 for ``sched`` (n_in = 8k, n_out = 8r), in
    ``design`` (default: ``design_for(sched)``)."""
    n_in, n_out = sched.n_in, sched.n_out
    if n_in % 8 or n_out % 8:
        raise ValueError(f"schedule {sched.digest} is {n_out}x{n_in}: K3 "
                         f"needs whole bytes (multiples of 8) on both sides")
    design = design or design_for(sched)
    k, r = n_in // 8, n_out // 8
    if design.kind == "register":
        body = _register_body(sched)
        what = (f"register design: {sched.n_terms} XORs (naive "
                f"{sched.naive_terms}), peak {sched.peak_registers} live "
                f"temporaries")
    else:
        body = [line for rows in design.tiles
                for line in _tile_body(sched, rows)]
        what = (f"tiled design: {len(design.tiles)} tile(s) of at most "
                f"{max(len(t) for t in design.tiles)} rows, input rows "
                f"fetched per tile")
    return "\n".join([
        "// Generated by ceph_tpu_torch/ops/xor_sched_codegen.py; do not edit.",
        f"// Schedule {sched.digest}: {n_out}x{n_in} GF(2) matrix; {what}; "
        f"{design.tag}.",
        f'#include "{HEADER}"',
        "",
        "namespace {",
        "",
        "struct Body {",
        f"  static constexpr int K = {k};",
        f"  static constexpr int R = {r};",
        f"  static constexpr int kThreads = {design.threads};",
        f"  static constexpr int kMinBlocks = {design.min_blocks};",
        "  XS_FN void operator()(const xor_sched::Io& io) const {",
        *body,
        "  }",
        "};",
        "",
        "}  // namespace",
        "",
        f"XOR_SCHED_ENTRY({entry_name(sched)}, Body)",
        "",
    ])
