"""PathFinder (Table 2: 32x32 grid traversal DP). ~6 active vregs."""

from __future__ import annotations

import numpy as np

from . import isa
from .scalar import ScalarCost
from .trace import Assembler, MemoryMap
from . import common

PAPER = dict(rows=32, cols=32)
REDUCED = dict(rows=8, cols=16)


def _padded(row: np.ndarray, width: int) -> np.ndarray:
    """[BIG, row..., BIG, align-pad] so j-1/j+1 reads are sentinel-guarded."""
    buf = np.full(width, common.BIG, np.float32)
    buf[1:1 + row.size] = row
    return buf


@common.register_benchmark(
    "pathfinder", domain="Grid Traversal", paper_params=PAPER,
    reduced_params=REDUCED, table2="Rows:32 Columns:32")
def build(rows=32, cols=32, seed=0) -> common.Built:
    assert cols % isa.VL_ELEMS == 0
    g = common.rng(seed)
    wall = g.integers(0, 10, (rows, cols)).astype(np.float32)
    width = cols + 2
    width += (-width) % isa.VL_ELEMS          # align each DP buffer

    mm = MemoryMap()
    awall = mm.alloc("wall", wall)
    bufs = [mm.alloc("buf0", _padded(wall[0], width)),
            mm.alloc("buf1", _padded(np.zeros(cols, np.float32), width))]

    a = Assembler("pathfinder")
    chunks = cols // isa.VL_ELEMS
    for i in range(1, rows):
        src = bufs[(i - 1) % 2]
        dst = bufs[i % 2]
        with a.repeat(chunks):
            a.vle(1, src + 0, stride=32)       # src[j-1] (aligned)
            a.vle(2, src + 4, stride=32)       # src[j]   (straddles lines)
            a.vle(3, src + 8, stride=32)       # src[j+1]
            a.vmin(4, 1, 2)
            a.vmin(4, 4, 3)
            a.vle(5, awall + i * cols * 4, stride=32)
            a.vadd(6, 4, 5)
            a.vse(6, dst + 4, stride=32)
            a.scalar(3)
        a.scalar(4)
    prog = a.finalize(mm)

    res = wall[0].astype(np.float64)
    for i in range(1, rows):
        pad = np.full(cols + 2, common.BIG, np.float64)
        pad[1:-1] = res
        res = wall[i] + np.minimum(np.minimum(pad[:-2], pad[1:-1]), pad[2:])
    final = _padded(np.zeros(cols, np.float32), width).astype(np.float64)
    final[1:1 + cols] = res
    name = "buf1" if (rows - 1) % 2 else "buf0"
    return common.Built(prog, {name: final.astype(np.float32)})


def scalar_cost(rows=32, cols=32, **_) -> ScalarCost:
    n = (rows - 1) * cols
    # per element: min3 = 2 compare+branch+mv sequences (branchy on an
    # in-order core: ~4 int ops each incl. flush), 1 add, 3 lw, 1 sw.
    return ScalarCost(int_ops=9 * n, loads=3 * n, stores=n,
                      unique_lines=rows * cols // 8 * 2, loop_iters=n)
