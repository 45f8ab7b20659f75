"""im2col GEMM kernel backing the DenseNet121-L105 and ResNet50-L10 rows of
Table 2 (the paper maps those CNN layers to matrix multiplication).

C(M,N) = A(M,K) @ B(K,N), vectorised along N.  Inner K loop streams one
broadcast A element + one B row chunk into a single accumulator: exactly 4
active vregs (acc, a, b, zero), matching Table 3's "4 active registers"
for both CNN layers.
"""

from __future__ import annotations

import numpy as np

from . import isa
from .scalar import ScalarCost
from .trace import Assembler, MemoryMap
from . import common

DENSENET = dict(m=32, k=1152, n=64)      # DenseNet121 layer 105 (im2col)
RESNET = dict(m=128, k=256, n=784)       # ResNet50 layer 10 (im2col)
PAPER = DENSENET
REDUCED = dict(m=4, k=16, n=16)

ACC, AR, BR, ZR = 1, 2, 3, 31


@common.register_benchmark(
    "resnet50_l10", domain="CNN", paper_params=RESNET,
    reduced_params=REDUCED, table2="(128 x 256)x(256 x 784)")
@common.register_benchmark(
    "densenet121_l105", domain="CNN", paper_params=DENSENET,
    reduced_params=REDUCED, table2="(32 x 1152)x(1152 x 64)")
def build(m=32, k=1152, n=64, seed=0) -> common.Built:
    assert n % isa.VL_ELEMS == 0
    g = common.rng(seed)
    A = (g.standard_normal((m, k)) / np.sqrt(k)).astype(np.float32)
    B = (g.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)

    mm = MemoryMap()
    aa = mm.alloc("A", A)
    ab = mm.alloc("B", B)
    ac = mm.alloc("C", m * n)
    az = mm.alloc("zero", np.zeros(1, np.float32))

    a = Assembler("gemm")
    a.vbcast(ZR, az)
    chunks = n // isa.VL_ELEMS
    with a.repeat(m):                    # row loop: stride3 = per-row pitch
        with a.repeat(chunks):
            a.vmv(ACC, ZR)
            with a.repeat(k):
                a.vbcast(AR, aa, stride=4, stride2=0, stride3=k * 4)
                a.vle(BR, ab, stride=n * 4, stride2=32, stride3=0)
                a.vmacc(ACC, AR, BR)
            a.vse(ACC, ac, stride=32, stride2=n * 4)
            a.scalar(3)
        a.scalar(3)
    prog = a.finalize(mm)
    C = (A.astype(np.float64) @ B.astype(np.float64)).astype(np.float32)
    return common.Built(prog, {"C": C}, rtol=2e-4, atol=1e-5)


def scalar_cost(m=32, k=1152, n=64, **_) -> ScalarCost:
    macs = m * k * n
    # per MAC: lw b, fmadd (a kept in a scalar register per k step).
    return ScalarCost(flop_ops=macs, loads=macs + m * k, stores=m * n,
                      unique_lines=(m * k + k * n + m * n) // 8,
                      loop_iters=macs)
