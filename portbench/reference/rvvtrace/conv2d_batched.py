"""Batched multi-channel 2-D convolution (beyond-paper CNN workload).

A four-deep loop nest — batch x output-row-pair x column-chunk x input
channel — that the three fixed stride levels of the old ``Assembler.repeat``
could not express: the input loads advance along FOUR axes (channel plane,
chunk, row pitch, batch image), exercising the general per-level stride
vector.  Structure follows ``rvv.conv2d`` (two output rows per pass share
the broadcast weights); the channel loop accumulates into the same ACC
registers across planes.

Every batch image is padded to a whole number of L1 way-spans (8 KB), so
consecutive batch iterations touch the *same* cache sets and the batch loop
reaches a translation-invariant steady state the periodic-folding engine
can certify exact (warm-up + two measured images, rest extrapolated).
"""

from __future__ import annotations

import numpy as np

from . import isa
from .scalar import ScalarCost
from .trace import Assembler, MemoryMap
from . import common
from .conv2d import ACC0, ACC1, ZR, emit_taps

PAPER = dict(n=32, f=3, batch=8, cin=2)
REDUCED = dict(n=16, f=3, batch=2, cin=2)

# Plane pitch: pad each (channel or output) plane to a whole number of L1
# way-spans so the batch-axis address translation is set-congruent.
_WAY_SPAN_WORDS = 2048            # 8 KB / 4-byte words (256 sets x 32 B)


def _plane_words(n: int) -> int:
    need = n * n + 64             # + overhang for the last column chunk
    return -(-need // _WAY_SPAN_WORDS) * _WAY_SPAN_WORDS


@common.register_benchmark(
    "conv2d_batched", domain="CNN", paper_params=PAPER,
    reduced_params=REDUCED, table2="32 x 32 x2ch x8imgs filter size:3")
def build(n=32, f=3, batch=8, cin=2, seed=0) -> common.Built:
    g = common.rng(seed)
    out_n = n - f + 1
    assert out_n % 2 == 0
    chunks = (out_n + isa.VL_ELEMS - 1) // isa.VL_ELEMS
    pw = _plane_words(n)

    img = g.standard_normal((batch, cin, n, n)).astype(np.float32)
    w = (g.standard_normal((cin, f, f)) / f).astype(np.float32)
    img_pad = np.zeros((batch, cin, pw), np.float32)
    img_pad[:, :, : n * n] = img.reshape(batch, cin, n * n)

    mm = MemoryMap()
    ai = mm.alloc("img", img_pad)
    aw = mm.alloc("w", w)
    aos = [mm.alloc(f"out{b}", pw) for b in range(batch)]
    az = mm.alloc("zero", np.zeros(1, np.float32))

    rs = n * 4                    # input row stride (bytes)
    chan = pw * 4                 # channel-plane pitch (bytes)
    bimg = cin * pw * 4           # batch-image pitch (bytes)
    bout = aos[1] - aos[0] if batch > 1 else 0

    a = Assembler("conv2d_batched")
    a.vbcast(ZR, az)
    with a.repeat(batch):                        # L3: batch image
        with a.repeat(out_n // 2):               # L2: row-pair pitch
            with a.repeat(chunks):               # L1: column chunk
                a.vmv(ACC0, ZR)
                a.vmv(ACC1, ZR)
                with a.repeat(cin):              # L0: channel plane
                    for fr in range(f):
                        emit_taps(a, ai, aw, fr, f, rs,
                                  in_strides=(chan, 32, 2 * rs, bimg),
                                  w_strides=(f * f * 4,))
                a.vse(ACC0, aos[0], strides=(32, 2 * rs, bout))
                a.vse(ACC1, aos[0] + rs, strides=(32, 2 * rs, bout))
                a.scalar(4)
            a.scalar(4)
        a.scalar(2)
    prog = a.finalize(mm)

    # f64 mirror (same channel-then-fr-then-fc accumulation order).
    I = img.astype(np.float64)
    regions = {}
    for b in range(batch):
        ref = np.zeros((out_n, out_n))
        for c in range(cin):
            for fr in range(f):
                for fc in range(f):
                    ref += (I[b, c, fr:fr + out_n, fc:fc + out_n]
                            * float(w[c, fr, fc]))
        regions[f"out{b}"] = (ref.astype(np.float32), n)
    return common.Built(prog, {}, rtol=2e-4, atol=1e-5, regions=regions)


def scalar_cost(n=32, f=3, batch=8, cin=2, **_) -> ScalarCost:
    out_n = n - f + 1
    taps = batch * cin * out_n * out_n * f * f
    return ScalarCost(flop_ops=taps, loads=taps,
                      stores=batch * out_n * out_n,
                      unique_lines=batch * cin * n * n // 8,
                      loop_iters=taps // f)
