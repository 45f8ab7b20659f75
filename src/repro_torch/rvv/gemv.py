"""GemV (Table 2, NLP: (512x512) x 512). Two-row unrolled; ~8 active vregs."""

from __future__ import annotations

import numpy as np

from repro_torch.core import isa
from repro_torch.core.simulator import ScalarCost
from repro_torch.core.trace import Assembler, MemoryMap
from repro_torch.rvv import common

PAPER = dict(m=512, k=512)
REDUCED = dict(m=16, k=32)

Z = 31     # register holding broadcast 0.0


@common.register_benchmark(
    "gemv", domain="NLP", paper_params=PAPER, reduced_params=REDUCED,
    table2="(512 x 512) x 512")
def build(m=512, k=512, seed=0) -> common.Built:
    assert k % isa.VL_ELEMS == 0 and m % 2 == 0
    g = common.rng(seed)
    A = g.standard_normal((m, k)).astype(np.float32) / np.sqrt(k)
    x = g.standard_normal(k).astype(np.float32)

    mm = MemoryMap()
    aA = mm.alloc("A", A)
    ax = mm.alloc("x", x)
    ay = mm.alloc("y", m)
    az = mm.alloc("zero", np.zeros(1, np.float32))

    a = Assembler("gemv")
    a.vbcast(Z, az)
    with a.repeat(m // 2):               # row-pair loop
        a.vmv(4, Z)                  # acc0 = 0
        a.vmv(5, Z)                  # acc1 = 0
        with a.repeat(k // isa.VL_ELEMS):
            a.vle(1, ax, stride=32, stride2=0)
            a.vle(2, aA, stride=32, stride2=2 * k * 4)
            a.vmacc(4, 1, 2)
            a.vle(3, aA + k * 4, stride=32, stride2=2 * k * 4)
            a.vmacc(5, 1, 3)
            a.scalar(3)
        a.vredsum(6, Z, 4)
        a.vses(6, ay, stride=8)
        a.vredsum(6, Z, 5)
        a.vses(6, ay + 4, stride=8)
        a.scalar(4)
    prog = a.finalize(mm)
    y = (A.astype(np.float64) @ x.astype(np.float64)).astype(np.float32)
    return common.Built(prog, {"y": y})


def scalar_cost(m=512, k=512, **_) -> ScalarCost:
    # per (i,k): lw a, lw x (x L1-resident), fmadd + loop.
    n = m * k
    return ScalarCost(flop_ops=n, loads=2 * n, stores=m,
                      unique_lines=n // 8 + k // 8, loop_iters=n)
