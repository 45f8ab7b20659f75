"""Jacobi-2D (Table 2: problem size 128, 10 steps). ~7 active vregs.

The time loop ping-pongs between two grids, so consecutive steps touch
*different* buffers and no single emitted repeat block is periodic — but
the whole trace is periodic with period TWO steps.  ``core.folding``'s
state-snapshot pass detects that k = 2 super-period across the per-step
row-loop blocks and certifies the fold exact (the exact-outer plan keeps
warm-up + two full ping-pong periods and extrapolates the rest
bit-identically)."""

from __future__ import annotations

import numpy as np

from . import isa
from .scalar import ScalarCost
from .trace import Assembler, MemoryMap
from . import common

PAPER = dict(n=128, steps=10)
REDUCED = dict(n=16, steps=2)


def _stride_words(n: int) -> int:
    w = n + 2
    w += (-w) % isa.VL_ELEMS
    return w


@common.register_benchmark(
    "jacobi2d", domain="Engineering", paper_params=PAPER,
    reduced_params=REDUCED, table2="Problem size:128 steps:10")
def build(n=128, steps=10, seed=0) -> common.Built:
    assert n % isa.VL_ELEMS == 0
    g = common.rng(seed)
    w = _stride_words(n)                     # padded row width (words)
    grid = np.zeros((n + 2, w), np.float32)
    grid[1:n + 1, 1:n + 1] = g.random((n, n), dtype=np.float32)

    mm = MemoryMap()
    a0 = mm.alloc("g0", grid)
    a1 = mm.alloc("g1", grid)                # ping-pong copy (halo included)
    rs = w * 4                               # row stride in bytes

    a = Assembler("jacobi2d")
    chunks = n // isa.VL_ELEMS
    for s in range(steps):
        src = (a0, a1)[s % 2]
        dst = (a0, a1)[(s + 1) % 2]
        with a.repeat(n):                            # grid rows: stride2 = rs
            r = src + rs                             # first interior row
            with a.repeat(chunks):
                a.vle(1, r - rs + 4, stride=32, stride2=rs)     # up
                a.vle(2, r + rs + 4, stride=32, stride2=rs)     # down
                a.vle(3, r + 0, stride=32, stride2=rs)          # left
                a.vle(4, r + 8, stride=32, stride2=rs)          # right
                a.vle(5, r + 4, stride=32, stride2=rs)          # center
                a.vadd(6, 1, 2)
                a.vadd(6, 6, 3)
                a.vadd(6, 6, 4)
                a.vadd(6, 6, 5)
                a.vmul_sc(6, 6, 0.2)
                a.vse(6, dst + rs + 4, stride=32, stride2=rs)
                a.scalar(3)
            a.scalar(4)
    prog = a.finalize(mm)

    # f64 mirror with identical association order.
    ref = grid.astype(np.float64)
    buf = ref.copy()
    for _ in range(steps):
        up = ref[0:n, 1:n + 1]
        dn = ref[2:n + 2, 1:n + 1]
        lf = ref[1:n + 1, 0:n]
        rt = ref[1:n + 1, 2:n + 2]
        ct = ref[1:n + 1, 1:n + 1]
        buf = ref.copy()
        buf[1:n + 1, 1:n + 1] = (((up + dn) + lf) + rt + ct) * 0.2
        ref, buf = buf, ref
    final = ref                                 # after `steps` swaps
    name = ("g0", "g1")[steps % 2]
    return common.Built(prog, {name: final.astype(np.float32)},
                        rtol=1e-4, atol=1e-6)


def scalar_cost(n=128, steps=10, **_) -> ScalarCost:
    pts = steps * n * n
    # per point: 4 fadd + 1 fmul + 5 lw (2 forwarded across j) + 1 sw.
    return ScalarCost(flop_ops=5 * pts, loads=3 * pts, stores=pts,
                      unique_lines=steps * (n * _stride_words(n) // 8),
                      loop_iters=pts)
