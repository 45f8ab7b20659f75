"""FlashAttention-2 self-attention layer (Table 2: seq 200, hidden 64,
Br=1, Bc=128) vectorised for RVV, as in the paper's BERT benchmark.

Key property reproduced from the paper (Table 3 + Fig 5): the kernel touches
ALL 32 architectural vector registers over its execution — register names
rotate across query rows and phases, as a compiler allocates fresh names
across unrolled phases — yet each phase's instantaneous working set is ~3
registers, so a cVRF of only 3 entries already achieves a >95% hit rate.

Online-softmax state (running max m, normaliser l, output accumulator) is
memory-resident and round-trips through scratch (vredmax/vses + vbcast), as
real RVV code moves lane-0 scalars; exp() is the shared squaring
approximation from ``rvv.common`` (identical in trace and reference).
"""

from __future__ import annotations

import numpy as np

from . import isa
from .scalar import ScalarCost
from .trace import Assembler, MemoryMap
from . import common

PAPER = dict(seq=200, d=64, bc=128)
REDUCED = dict(seq=16, d=16, bc=8)

NEG = -1e9
VL = isa.VL_ELEMS


def _rot(i: int) -> int:
    """Rotating register base: phases cycle through v1..v30 in groups of 3."""
    return 1 + 3 * (i % 10)


def scratch_buffers(mm: MemoryMap, seq: int, d: int) -> dict:
    """Online-softmax scratch shared by FA-2 and the multi-head kernel."""
    return dict(
        aS=mm.alloc("S", seq),          # score/prob row scratch
        am=mm.alloc("m", VL),           # running max (all lanes)
        amold=mm.alloc("mold", VL),     # previous running max
        al=mm.alloc("l", VL),           # normaliser (all lanes)
        asum=mm.alloc("psum", VL),      # block prob-sum scratch
        aacc=mm.alloc("acc", d),        # output accumulator scratch
        az=mm.alloc("zero", np.zeros(1, np.float32)),
        an=mm.alloc("neginf", np.full(1, NEG, np.float32)),
        ac=mm.alloc("clamp", np.full(1, common.EXP_CLAMP, np.float32)),
    )


def emit_attention(a: Assembler, bufs: dict, seq: int, d: int, bc: int,
                   head_advs: dict | None = None) -> None:
    """Emit one full FlashAttention-2 pass over ``seq`` query rows.

    ``bufs`` holds the Q/KT/V/O base addresses plus the scratch from
    :func:`scratch_buffers`.  ``head_advs`` (keys ``q``/``kt``/``v``/``o``)
    appends one more per-level stride to every Q/KT/V/O access so an
    enclosing head ``repeat`` advances the planes — the multi-head kernel's
    fourth stride level.  With ``head_advs=None`` the emission is exactly
    the single-head FA-2 trace.
    """
    aq, akt, av, ao = bufs["aq"], bufs["akt"], bufs["av"], bufs["ao"]
    aS, am, amold = bufs["aS"], bufs["am"], bufs["amold"]
    al, asum, aacc = bufs["al"], bufs["asum"], bufs["aacc"]
    az, an, ac = bufs["az"], bufs["an"], bufs["ac"]
    scale = 1.0 / np.sqrt(d)
    dc = d // VL                               # output chunks per row
    n_blocks = (seq + bc - 1) // bc
    # The register rotation has period 10, so 10 consecutive query rows form
    # one periodic block: emit them inside a repeat (with the per-group Q/O
    # advance as the outermost stride) so the trace carries fold metadata.
    group = 10 if seq % 10 == 0 else 1
    grp_adv = group * d * 4 if group > 1 else 0

    def sfx(grp_stride, head_key):
        """Outer stride levels beyond a Q/KT/V/O access's own loops: the
        row-group advance (when grouped) then the head-plane advance."""
        t = (grp_stride,) if group > 1 else ()
        return t + ((head_advs[head_key],) if head_advs else ())

    def emit_row(i):
        # ---- row init: acc = 0, m = -inf, l = 0 (memory-resident state)
        a.vbcast(31, az)
        with a.repeat(dc):
            a.vse(31, aacc, stride=32)
        a.vbcast(30, an)
        a.vse(30, am)
        a.vse(31, al)
        a.scalar(2)

        for b in range(n_blocks):
            j0 = b * bc
            jn = min(bc, seq - j0)
            bchunks = jn // VL

            # ---- phase 1: s[j] = scale * (q_i . k_j), vectorised over j
            r0, r1, r2 = (_rot(i) + k for k in range(3))
            with a.repeat(bchunks):
                a.vbcast(r0, az)
                with a.repeat(d):
                    a.vbcast(r1, aq + i * d * 4,
                             strides=(4, 0) + sfx(grp_adv, "q"))
                    a.vle(r2, akt + j0 * 4,
                          strides=(seq * 4, 32) + sfx(0, "kt"))
                    a.vmacc(r0, r1, r2)
                a.vmul_sc(r0, r0, scale)
                a.vse(r0, aS + j0 * 4, stride=32)
                a.scalar(3)

            # ---- phase 2: m_old save + block running max
            m0, m1, _ = (_rot(i + 3) + k for k in range(3))
            a.vle(m0, am)
            a.vse(m0, amold)                   # save m_old
            with a.repeat(bchunks):
                a.vle(m1, aS + j0 * 4, stride=32)
                a.vredmax(m0, m0, m1)          # m0[0] accumulates block max
                a.scalar(1)
            a.vses(m0, am)
            a.vbcast(m0, am)                   # all lanes = m_new
            a.vse(m0, am)                      # keep invariant: am broadcast

            # ---- phase 3: p = exp(s - m_new); sum(p)
            p0, p1, p2 = (_rot(i + 6) + k for k in range(3))
            a.vbcast(p2, ac)                   # clamp const
            a.vbcast(p0, az)                   # partial sum = 0
            with a.repeat(bchunks):
                a.vle(p1, aS + j0 * 4, stride=32)
                a.vsub(p1, p1, m0)
                common.emit_exp(a, p1, p2)
                a.vse(p1, aS + j0 * 4, stride=32)
                a.vredsum(p0, p0, p1)          # p0[0] accumulates sum
                a.scalar(1)
            a.vses(p0, asum)

            # ---- phase 4: corr = exp(m_old - m_new); l = l*corr + sum(p)
            c0, c1, c2 = (_rot(i + 9) + k for k in range(3))
            a.vle(c0, amold)
            a.vsub(c0, c0, m0)
            a.vbcast(c2, ac)
            common.emit_exp(a, c0, c2)         # corr (all lanes)
            a.vle(c1, al)
            a.vmul(c1, c1, c0)
            a.vbcast(c2, asum)
            a.vadd(c1, c1, c2)
            a.vse(c1, al)

            # ---- phase 5: acc = acc*corr + P . V  (vectorised over d)
            with a.repeat(dc):
                a.vle(c1, aacc, stride=32)
                a.vmul(c1, c1, c0)
                a.vse(c1, aacc, stride=32)
            v0, v1, v2 = (_rot(i + 12) + k for k in range(3))
            with a.repeat(jn):
                a.vbcast(v0, aS + j0 * 4, stride=4)       # p_j
                with a.repeat(dc):
                    a.vle(v1, av + j0 * d * 4,
                          strides=(32, d * 4) + sfx(0, "v"))
                    a.vle(v2, aacc, stride=32)
                    a.vmacc(v2, v0, v1)
                    a.vse(v2, aacc, stride=32)
                a.scalar(2)

        # ---- epilogue: O[i] = acc / l
        o0, o1, _ = (_rot(i + 15) + k for k in range(3))
        a.vle(o1, al)
        with a.repeat(dc):
            a.vle(o0, aacc, stride=32)
            a.vdiv(o0, o0, o1)
            a.vse(o0, ao + i * d * 4, strides=(32,) + sfx(grp_adv, "o"))
        a.scalar(3)

    if group > 1:
        with a.repeat(seq // group):
            for i0 in range(group):
                emit_row(i0)
    else:
        for i in range(seq):
            emit_row(i)


def reference_attention(Q, K, V, bc: int) -> np.ndarray:
    """f64 mirror of :func:`emit_attention`: same blocking, same exp
    approximation, same association order."""
    seq, d = Q.shape
    scale = 1.0 / np.sqrt(d)
    n_blocks = (seq + bc - 1) // bc
    Qd, Kd, Vd = (x.astype(np.float64) for x in (Q, K, V))
    O = np.zeros((seq, d))
    for i in range(seq):
        m, l = NEG, 0.0
        acc = np.zeros(d)
        for b in range(n_blocks):
            j0 = b * bc
            jn = min(bc, seq - j0)
            s = scale * (Kd[j0:j0 + jn] @ Qd[i])
            m_new = max(m, s.max())
            p = common.np_exp_approx(s - m_new)
            corr = float(common.np_exp_approx(np.array(m - m_new)))
            l = l * corr + p.sum()
            acc = acc * corr + p @ Vd[j0:j0 + jn]
            m = m_new
        O[i] = acc / l
    return O


@common.register_benchmark(
    "flashattention2", domain="Transformer", paper_params=PAPER,
    reduced_params=REDUCED,
    table2="Seq. Length:200 Hidden Dim.:64 Block row:1 Block col:128")
def build(seq=200, d=64, bc=128, seed=0) -> common.Built:
    assert seq % VL == 0 and d % VL == 0 and bc % VL == 0
    g = common.rng(seed)
    Q = (g.standard_normal((seq, d)) * 0.3).astype(np.float32)
    K = (g.standard_normal((seq, d)) * 0.3).astype(np.float32)
    V = g.standard_normal((seq, d)).astype(np.float32)

    mm = MemoryMap()
    bufs = dict(
        aq=mm.alloc("Q", Q),
        akt=mm.alloc("KT", np.ascontiguousarray(K.T)),   # (d, seq)
        av=mm.alloc("V", V),
        ao=mm.alloc("O", seq * d),
    )
    bufs.update(scratch_buffers(mm, seq, d))

    a = Assembler("flashattention2")
    emit_attention(a, bufs, seq, d, bc)
    prog = a.finalize(mm)

    O = reference_attention(Q, K, V, bc)
    return common.Built(prog, {"O": O.astype(np.float32)},
                        rtol=5e-3, atol=1e-4)


def reference_softmax(seq=200, d=64, seed=0, **_) -> np.ndarray:
    """True-softmax attention for the loose sanity check in tests."""
    g = common.rng(seed)
    Q = (g.standard_normal((seq, d)) * 0.3).astype(np.float32)
    K = (g.standard_normal((seq, d)) * 0.3).astype(np.float32)
    V = g.standard_normal((seq, d)).astype(np.float32)
    s = (Q @ K.T) / np.sqrt(d)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    return p @ V


def scalar_cost(seq=200, d=64, **_) -> ScalarCost:
    # scores+PV: 2*seq^2*d MACs + lw; scalar softmax pays a libm-style
    # exp (~25 flop-equivalents per element).
    macs = 2 * seq * seq * d
    sm = 25 * seq * seq
    return ScalarCost(flop_ops=macs + sm, loads=macs + 2 * seq * seq,
                      stores=seq * d + 2 * seq * seq,
                      unique_lines=(3 * seq * d) // 8 * (seq // 16),
                      loop_iters=macs)
