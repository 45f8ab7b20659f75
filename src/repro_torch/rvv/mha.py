"""Multi-head self-attention (beyond-paper Transformer workload).

Wraps the FlashAttention-2 emission core (``rvv.flashattention2``) in a
head ``repeat``: every Q/KT/V/O access gains a FOURTH per-level stride (the
head-plane pitch) on top of its own loop levels — broadcast-within-dot (4),
KT column walk, row-group advance — which the old fixed three-level
``Assembler.repeat`` could not express.  The online-softmax scratch (S, m,
l, acc) is shared across heads, exactly as a single-core RVV implementation
would reuse its scratch.

Register names rotate through v1..v30 across query rows and phases (the
paper's Table 3 full-utilisation property), so the per-head instruction
block is identical and the head loop is a clean candidate for periodic
folding: head planes are padded to whole L1 way-spans (8 KB) so consecutive
heads touch the same cache sets, and the folding engine certifies the head
loop exact (warm-up + two measured heads, rest extrapolated).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.simulator import ScalarCost
from repro_torch.core.trace import Assembler, MemoryMap
from repro_torch.rvv import common
from repro_torch.rvv.flashattention2 import (VL, emit_attention,
                                       reference_attention, scratch_buffers)

PAPER = dict(seq=40, d=16, bc=40, heads=8)
REDUCED = dict(seq=16, d=16, bc=16, heads=2)

# Head-plane pitch: pad every per-head Q/KT/V/O plane to a whole number of
# L1 way-spans so the head-axis address translation is set-congruent.
_WAY_SPAN_WORDS = 2048            # 8 KB / 4-byte words (256 sets x 32 B)


def _plane_words(seq: int, d: int) -> int:
    return -(-(seq * d) // _WAY_SPAN_WORDS) * _WAY_SPAN_WORDS


@common.register_benchmark(
    "mha", domain="Transformer", paper_params=PAPER, reduced_params=REDUCED,
    table2="Seq:40 Head Dim.:16 Heads:8")
def build(seq=40, d=16, bc=40, heads=8, seed=0) -> common.Built:
    assert seq % VL == 0 and d % VL == 0 and bc % VL == 0
    g = common.rng(seed)
    pw = _plane_words(seq, d)
    Q = (g.standard_normal((heads, seq, d)) * 0.3).astype(np.float32)
    K = (g.standard_normal((heads, seq, d)) * 0.3).astype(np.float32)
    V = g.standard_normal((heads, seq, d)).astype(np.float32)

    def planes(x):                      # (H, seq*d) -> (H, pw) padded planes
        out = np.zeros((heads, pw), np.float32)
        out[:, : seq * d] = x.reshape(heads, seq * d)
        return out

    KT = np.stack([np.ascontiguousarray(K[h].T) for h in range(heads)])
    mm = MemoryMap()
    bufs = dict(
        aq=mm.alloc("Q", planes(Q)),
        akt=mm.alloc("KT", planes(KT)),
        av=mm.alloc("V", planes(V)),
        ao=mm.alloc("O", heads * pw),
    )
    bufs.update(scratch_buffers(mm, seq, d))
    adv = pw * 4                        # head-plane pitch (bytes)

    a = Assembler("mha")
    with a.repeat(heads):
        emit_attention(a, bufs, seq, d, bc,
                       head_advs=dict(q=adv, kt=adv, v=adv, o=adv))
    prog = a.finalize(mm)

    O = np.zeros((heads, pw), np.float32)
    for h in range(heads):
        O[h, : seq * d] = reference_attention(
            Q[h], K[h], V[h], bc).astype(np.float32).reshape(-1)
    return common.Built(prog, {"O": O}, rtol=5e-3, atol=1e-4)


def scalar_cost(seq=40, d=16, heads=8, **_) -> ScalarCost:
    # per head: scores + PV MACs, plus the scalar-softmax exp cost
    # (~25 flop-equivalents per element), as in flashattention2.
    macs = heads * 2 * seq * seq * d
    sm = 25 * heads * seq * seq
    return ScalarCost(flop_ops=macs + sm,
                      loads=macs + 2 * heads * seq * seq,
                      stores=heads * (seq * d + 2 * seq * seq),
                      unique_lines=heads * (3 * seq * d) // 8,
                      loop_iters=macs)
