"""fconv2d-7x7 (Table 2: 256x256 input, 7x7 filter, valid). ~13 vregs.

Two output rows are computed per pass sharing the broadcast filter weights
(the "strategic grouping and unrolling of vector register names" the paper
credits for fconv2d's resilience, Fig 6 discussion).

The tap-loop emission (:func:`emit_taps`) is shared with the batched
multi-channel variant (``rvv.conv2d_batched``), which wraps it in channel
and batch repeats using the per-level stride vectors of
``Assembler.repeat``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import isa
from repro_torch.core.simulator import ScalarCost
from repro_torch.core.trace import Assembler, MemoryMap
from repro_torch.rvv import common

PAPER = dict(n=256, f=7)
REDUCED = dict(n=32, f=7)

ACC0, ACC1, IN0, IN1 = 1, 2, 3, 4
W = list(range(9, 16))          # v9..v15 hold one filter row
ZR = 31


def emit_taps(a: Assembler, ai: int, aw: int, fr: int, f: int, rs: int,
              in_strides: tuple, w_strides: tuple = ()) -> None:
    """One filter row of the two-output-row conv body: broadcast the f
    weights of filter row ``fr``, then accumulate the f taps into ACC0/ACC1.

    ``in_strides``/``w_strides`` are per-level stride vectors for the input
    loads and weight broadcasts (the enclosing repeats decide how many
    levels are live: chunk, row-pair, channel, batch).
    """
    for fc in range(f):
        a.vbcast(W[fc], aw + (fr * f + fc) * 4, strides=w_strides)
    for fc in range(f):
        a.vle(IN0, ai + fr * rs + fc * 4, strides=in_strides)
        a.vmacc(ACC0, IN0, W[fc])
        a.vle(IN1, ai + (1 + fr) * rs + fc * 4, strides=in_strides)
        a.vmacc(ACC1, IN1, W[fc])


@common.register_benchmark(
    "conv2d_7x7", domain="CNN", paper_params=PAPER, reduced_params=REDUCED,
    table2="256 x 256 filter size:7")
def build(n=256, f=7, seed=0) -> common.Built:
    g = common.rng(seed)
    img = g.standard_normal((n, n)).astype(np.float32)
    w = (g.standard_normal((f, f)) / f).astype(np.float32)
    out_n = n - f + 1
    chunks = (out_n + isa.VL_ELEMS - 1) // isa.VL_ELEMS
    assert out_n % 2 == 0

    mm = MemoryMap()
    ai = mm.alloc("img", img)
    aw = mm.alloc("w", w)
    ao = mm.alloc("out", n * n + 64)      # padded: last chunk writes overhang
    az = mm.alloc("zero", np.zeros(1, np.float32))

    rs = n * 4
    a = Assembler("conv2d")
    a.vbcast(ZR, az)
    with a.repeat(out_n // 2):                   # row-pair loop: 2*rs pitch
        with a.repeat(chunks):
            a.vmv(ACC0, ZR)
            a.vmv(ACC1, ZR)
            for fr in range(f):
                emit_taps(a, ai, aw, fr, f, rs, in_strides=(32, 2 * rs))
            a.vse(ACC0, ao, stride=32, stride2=2 * rs)
            a.vse(ACC1, ao + rs, stride=32, stride2=2 * rs)
            a.scalar(4)
        a.scalar(4)
    prog = a.finalize(mm)

    # f64 mirror (same fr-then-fc accumulation order).
    ref = np.zeros((out_n, out_n))
    I = img.astype(np.float64)
    for fr in range(f):
        for fc in range(f):
            ref += I[fr:fr + out_n, fc:fc + out_n] * float(w[fr, fc])
    # Compare only the valid region of each padded output row.
    want = ref.astype(np.float32)
    return common.Built(prog, {}, rtol=2e-4, atol=1e-5,
                        regions={"out": (want, n)})


def scalar_cost(n=256, f=7, **_) -> ScalarCost:
    out_n = n - f + 1
    taps = out_n * out_n * f * f
    # per tap: lw + fmadd (weights in regs); the 7-tap fc loop is unrolled
    # by the compiler, leaving per-(pixel, filter-row) overhead.
    return ScalarCost(flop_ops=taps, loads=taps, stores=out_n * out_n,
                      unique_lines=n * n // 8, loop_iters=taps // f)
