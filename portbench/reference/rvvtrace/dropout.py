"""Dropout (Table 2: vector length 131072, scale 0.5). ~3 active vregs."""

from __future__ import annotations

import numpy as np

from . import isa
from .scalar import ScalarCost
from .trace import Assembler, MemoryMap
from . import common

PAPER = dict(n=131072, scale=0.5)
REDUCED = dict(n=512, scale=0.5)


@common.register_benchmark(
    "dropout", domain="ML", paper_params=PAPER, reduced_params=REDUCED,
    table2="Vector Length:131072 Scale:0.5")
def build(n=131072, scale=0.5, seed=0) -> common.Built:
    assert n % isa.VL_ELEMS == 0
    g = common.rng(seed)
    x = g.standard_normal(n).astype(np.float32)
    m = (g.random(n) < 0.5).astype(np.float32)   # precomputed binary mask

    mm = MemoryMap()
    ax = mm.alloc("x", x)
    am = mm.alloc("m", m)
    ay = mm.alloc("y", n)

    a = Assembler("dropout")
    with a.repeat(n // isa.VL_ELEMS):
        a.vle(1, ax, stride=32)
        a.vle(2, am, stride=32)
        a.vmul(3, 1, 2)
        a.vmul_sc(3, 3, scale)
        a.vse(3, ay, stride=32)
        a.scalar(3)                  # pointer bumps + branch
    prog = a.finalize(mm)
    expected = {"y": (x.astype(np.float64) * m * scale).astype(np.float32)}
    return common.Built(prog, expected)


def scalar_cost(n=131072, scale=0.5, **_) -> ScalarCost:
    # per element: lw x, lw m, fmul, fmul(scale), fsw + loop.
    return ScalarCost(flop_ops=2 * n, loads=2 * n, stores=n,
                      unique_lines=3 * n // 8, loop_iters=n)
