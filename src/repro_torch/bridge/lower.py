"""Lowering: LayerOps -> certified-foldable ``Assembler.repeat`` programs
(the port of the reference's ``bridge/lower.py``, numpy only: the programs
are bit-equal to the reference's).

Every op kind lowers to a fixed-shape *tile* program whose outer loops
certify exact under :mod:`repro_torch.core.folding`:

- ``gemm``: the :mod:`repro_torch.rvv.gemm` broadcast-MAC nest wrapped in
  a tile loop.  Per-tile A and C planes are padded to whole L1 way-spans
  (8 KB) so the tile axis is set-congruent and folds exact, exactly like
  the mha head loop.
- ``attn``: delegates to :func:`repro_torch.rvv.mha.build` at the bridge's
  attention tile — the head loop is already way-span padded there.
- ``scan``: an elementwise recurrence ``h <- a * h + x_t`` (the shared
  shape of the Mamba selective scan and the RG-LRU gate recurrence): ``h``
  and the decay ``a`` live at step-invariant addresses, the per-step input
  plane is way-span padded, so the step loop is set-congruent.

A tile covers a fixed sub-problem of the real layer; the ratio
real-work / tile-work is the layer's *macro factor*, used when aggregating
tile counters back to network totals.  Tile caps (``K_CAP``/``N_CAP``,
``ATTN_TILE``, ``SCAN_WIDTH_CAP``) bound trace length; the real shape
lives on in the kernel name and the macro factor.

``unroll=True`` on the emitters produces the same instruction stream with
explicit Python loops and literal addresses instead of ``repeat`` strides
— the property tests compare the two row-for-row.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import isa
from repro_torch.core.simulator import ScalarCost
from repro_torch.core.trace import Assembler, MemoryMap
from repro_torch.rvv import common, mha
from repro_torch.bridge.shapes import TOKEN_BLOCK, LayerOp

# Way-span padding: 8 KB (256 sets x 32 B line) in 4-byte words.  Planes
# padded to this pitch keep outer-loop iterations set-congruent.
_WAY_SPAN_WORDS = 2048

ACC, AR, BR, ZR = 1, 2, 3, 31           # gemm register roles (rvv.gemm)
HR, CR, XR = 4, 5, 6                    # scan register roles

# ---- tile caps (the lowering contract, see docs/bridge.md) ----------------
TILES, MT = 8, 2                        # gemm: 8 way-span tiles x 2 rows
K_CAP, N_CAP = 64, 32                   # gemm reduction / output caps
ATTN_TILE = dict(seq=16, d=32, bc=16, heads=8)
SCAN_STEPS, SCAN_WIDTH_CAP = 12, 512


def _pad(words: int) -> int:
    """Round a plane size up to a whole number of L1 way-spans."""
    return -(-words // _WAY_SPAN_WORDS) * _WAY_SPAN_WORDS


def _round8(x: int) -> int:
    """Clamp to a positive multiple of VL (vector stores need n % 8 == 0)."""
    return max(isa.VL_ELEMS, (x // isa.VL_ELEMS) * isa.VL_ELEMS)


# ---------------------------------------------------------------------------
# gemm tile
# ---------------------------------------------------------------------------


def build_gemm(tiles=TILES, mt=MT, k=K_CAP, n=N_CAP, seed=0,
               unroll=False) -> common.Built:
    """Tiled GEMM: ``tiles`` independent (mt x k) @ (k x n) products against
    a shared B.  A/C planes are way-span padded per tile, so the tile loop
    is set-congruent and folds exact; the inner nest is rvv.gemm's 4-vreg
    broadcast-MAC pattern."""
    assert n % isa.VL_ELEMS == 0 and k >= 1 and mt >= 1
    g = common.rng(seed)
    A = (g.standard_normal((tiles, mt, k)) / np.sqrt(k)).astype(np.float32)
    B = (g.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    pa, pc = _pad(mt * k), _pad(mt * n)

    Abuf = np.zeros((tiles, pa), np.float32)
    Abuf[:, : mt * k] = A.reshape(tiles, mt * k)
    mm = MemoryMap()
    aa = mm.alloc("A", Abuf)
    ab = mm.alloc("B", B)
    ac = mm.alloc("C", tiles * pc)
    az = mm.alloc("zero", np.zeros(1, np.float32))

    a = Assembler("net_gemm")
    a.vbcast(ZR, az)
    chunks = n // isa.VL_ELEMS
    if unroll:
        for t in range(tiles):
            for mi in range(mt):
                for c in range(chunks):
                    a.vmv(ACC, ZR)
                    for kk in range(k):
                        a.vbcast(AR, aa + 4 * kk + k * 4 * mi + pa * 4 * t)
                        a.vle(BR, ab + n * 4 * kk + 32 * c)
                        a.vmacc(ACC, AR, BR)
                    a.vse(ACC, ac + 32 * c + n * 4 * mi + pc * 4 * t)
                    a.scalar(3)
                a.scalar(3)
            a.scalar(3)
    else:
        with a.repeat(tiles):            # way-span-padded tile loop
            with a.repeat(mt):
                with a.repeat(chunks):
                    a.vmv(ACC, ZR)
                    with a.repeat(k):
                        a.vbcast(AR, aa, strides=(4, 0, k * 4, pa * 4))
                        a.vle(BR, ab, strides=(n * 4, 32, 0, 0))
                        a.vmacc(ACC, AR, BR)
                    a.vse(ACC, ac, strides=(32, n * 4, pc * 4))
                    a.scalar(3)
                a.scalar(3)
            a.scalar(3)
    prog = a.finalize(mm)

    C = np.zeros((tiles, pc), np.float32)
    for t in range(tiles):
        C[t, : mt * n] = (A[t].astype(np.float64)
                          @ B.astype(np.float64)).astype(np.float32).ravel()
    return common.Built(prog, {"C": C}, rtol=2e-4, atol=1e-5)


def gemm_scalar_cost(tiles=TILES, mt=MT, k=K_CAP, n=N_CAP, **_) -> ScalarCost:
    macs = tiles * mt * k * n
    return ScalarCost(flop_ops=macs, loads=macs + tiles * mt * k,
                      stores=tiles * mt * n,
                      unique_lines=(tiles * mt * (k + n) + k * n) // 8,
                      loop_iters=macs)


# ---------------------------------------------------------------------------
# scan tile
# ---------------------------------------------------------------------------


def build_scan(steps=SCAN_STEPS, width=SCAN_WIDTH_CAP, seed=0,
               unroll=False) -> common.Built:
    """Elementwise recurrence ``h <- a * h + x_t`` over ``width`` channels
    for ``steps`` steps (the data-flow shape shared by the Mamba selective
    scan and the RG-LRU).  ``h`` and ``a`` sit at step-invariant addresses;
    the per-step input plane is way-span padded, so the step loop is
    set-congruent and folds exact."""
    assert width % isa.VL_ELEMS == 0
    g = common.rng(seed)
    h0 = g.standard_normal(width).astype(np.float32)
    coef = (0.5 + 0.4 * g.random(width)).astype(np.float32)
    X = (g.standard_normal((steps, width)) * 0.1).astype(np.float32)
    pw = _pad(width)

    Xbuf = np.zeros((steps, pw), np.float32)
    Xbuf[:, :width] = X
    mm = MemoryMap()
    ah = mm.alloc("h", h0.copy())
    aco = mm.alloc("coef", coef)
    ax = mm.alloc("X", Xbuf)

    a = Assembler("net_scan")
    chunks = width // isa.VL_ELEMS
    if unroll:
        for t in range(steps):
            for c in range(chunks):
                a.vle(HR, ah + 32 * c)
                a.vle(CR, aco + 32 * c)
                a.vmul(HR, HR, CR)
                a.vle(XR, ax + 32 * c + pw * 4 * t)
                a.vadd(HR, HR, XR)
                a.vse(HR, ah + 32 * c)
                a.scalar(2)
            a.scalar(3)
    else:
        with a.repeat(steps):            # way-span-padded step loop
            with a.repeat(chunks):
                a.vle(HR, ah, strides=(32, 0))
                a.vle(CR, aco, strides=(32, 0))
                a.vmul(HR, HR, CR)
                a.vle(XR, ax, strides=(32, pw * 4))
                a.vadd(HR, HR, XR)
                a.vse(HR, ah, strides=(32, 0))
                a.scalar(2)
            a.scalar(3)
    prog = a.finalize(mm)

    h = h0.astype(np.float64)
    for t in range(steps):
        h = coef.astype(np.float64) * h + X[t].astype(np.float64)
    return common.Built(prog, {"h": h.astype(np.float32)},
                        rtol=2e-4, atol=1e-5)


def scan_scalar_cost(steps=SCAN_STEPS, width=SCAN_WIDTH_CAP,
                     **_) -> ScalarCost:
    updates = steps * width
    return ScalarCost(flop_ops=2 * updates, loads=3 * updates,
                      stores=updates,
                      unique_lines=(2 * width + updates) // 8,
                      loop_iters=updates)


# ---------------------------------------------------------------------------
# attn tile (delegates to the mha kernel)
# ---------------------------------------------------------------------------


def build_attn(seq=ATTN_TILE["seq"], d=ATTN_TILE["d"], bc=ATTN_TILE["bc"],
               heads=ATTN_TILE["heads"], seed=0) -> common.Built:
    """Attention tile: the mha FlashAttention-2 emission with way-span
    padded head planes (certified fold of the head loop)."""
    return mha.build(seq=seq, d=d, bc=bc, heads=heads, seed=seed)


def attn_scalar_cost(**kw) -> ScalarCost:
    return mha.scalar_cost(**kw)


# ---------------------------------------------------------------------------
# tile policy
# ---------------------------------------------------------------------------

_BUILDERS = {"gemm": build_gemm, "scan": build_scan, "attn": build_attn}
_COSTS = {"gemm": gemm_scalar_cost, "scan": scan_scalar_cost,
          "attn": attn_scalar_cost}


def tile_for(op: LayerOp) -> tuple[str, dict, float]:
    """(kernel name, build kwargs, macro factor) for a LayerOp.

    The kernel name encodes the op's *real* shape — ops with equal
    signatures share a kernel (and, since the build kwargs are a function
    of the signature alone, an identical trace); ops with different
    signatures never merge.  The macro factor is real work / tile work at
    the TOKEN_BLOCK workload unit.
    """
    if op.kind == "gemm":
        k, n = op.shape
        kwargs = dict(tiles=TILES, mt=MT, k=min(k, K_CAP),
                      n=_round8(min(n, N_CAP)))
        name = f"net:gemm:{k}x{n}"
        tile_work = kwargs["tiles"] * kwargs["mt"] * kwargs["k"] * kwargs["n"]
    elif op.kind == "attn":
        heads, hd = op.shape
        kwargs = dict(ATTN_TILE)
        name = f"net:attn:{heads}h{hd}"
        tile_work = (2 * kwargs["seq"] * kwargs["seq"] * kwargs["d"]
                     * kwargs["heads"])
    elif op.kind == "scan":
        (width,) = op.shape
        kwargs = dict(steps=SCAN_STEPS, width=_round8(min(width,
                                                          SCAN_WIDTH_CAP)))
        name = f"net:scan:{width}"
        tile_work = kwargs["steps"] * kwargs["width"]
    else:
        raise ValueError(f"unknown LayerOp kind {op.kind!r}")
    return name, kwargs, op.work / tile_work


def builder_for(kind: str):
    return _BUILDERS[kind]


def cost_for(kind: str):
    return _COSTS[kind]
