"""Somier (Table 2: 3-D spring-mass physics, size 32, 2 steps). ~14 vregs.

Per time step: force accumulation over the 6 grid neighbours (spring model
with sqrt-normalised direction, like RiVEC's somier), then velocity/position
integration.  Vectorised along z.

Folding stays honestly *uncertified* for this kernel: its steady state
spans a whole time step (force + integrate share the pos/vel/frc arrays at
different line rates, so cross-period reuse gaps inside the i-row loops are
non-stationary), and with only 2 paper-size steps the step-level period
detector never sees the >= 4 repetitions it needs to detect a stable
super-period — there is nothing to extrapolate.  See docs/folding.md.
"""

from __future__ import annotations

import numpy as np

from . import isa
from .scalar import ScalarCost
from .trace import Assembler, MemoryMap
from . import common

PAPER = dict(n=32, steps=2)
REDUCED = dict(n=8, steps=1)

K_SPRING = 0.4
L0 = 0.9
DT = 0.001

# registers
CX, CY, CZ = 1, 2, 3          # centre position
NX, NY, NZ = 4, 5, 6          # neighbour position
DX, DY, DZ = 7, 8, 9          # displacement
T1, T2 = 10, 11               # dist^2 / dist / coef temporaries
FX, FY, FZ = 12, 13, 14       # force accumulators
ZR = 31                       # broadcast zero
DTR = 30                      # broadcast dt


def _zpad(n: int) -> int:
    z = n + 2
    z += (-z) % isa.VL_ELEMS
    return z


@common.register_benchmark(
    "somier", domain="Physics Simulation", paper_params=PAPER,
    reduced_params=REDUCED, table2="Problem size:32 steps:2")
def build(n=32, steps=2, seed=0) -> common.Built:
    assert n % isa.VL_ELEMS == 0
    g = common.rng(seed)
    zp = _zpad(n)
    shape = (n + 2, n + 2, zp)
    pos = np.zeros((3,) + shape, np.float32)
    # Slightly perturbed lattice; halo equals the lattice so that edge springs
    # have near-rest length.
    ii = np.arange(n + 2)[:, None, None]
    jj = np.arange(n + 2)[None, :, None]
    kk = np.arange(zp)[None, None, :]
    base = np.stack([ii + 0 * jj + 0 * kk, jj + 0 * ii + 0 * kk,
                     kk + 0 * ii + 0 * jj]).astype(np.float32)
    pos = base.copy()
    pos[:, 1:n + 1, 1:n + 1, 1:n + 1] += (
        0.1 * g.standard_normal((3, n, n, n)).astype(np.float32))
    vel = np.zeros_like(pos)
    frc = np.zeros_like(pos)

    mm = MemoryMap()
    ap = [mm.alloc(f"pos{c}", pos[i]) for i, c in enumerate("xyz")]
    av = [mm.alloc(f"vel{c}", vel[i]) for i, c in enumerate("xyz")]
    af = [mm.alloc(f"frc{c}", frc[i]) for i, c in enumerate("xyz")]
    az = mm.alloc("zero", np.zeros(1, np.float32))
    adt = mm.alloc("dt", np.full(1, DT, np.float32))

    ys = zp * 4                       # byte stride along y
    xs = (n + 2) * ys                 # byte stride along x
    nbr_off = [xs, -xs, ys, -ys, 4, -4]
    chunks = n // isa.VL_ELEMS

    a = Assembler("somier")
    a.vbcast(ZR, az)
    a.vbcast(DTR, adt)
    off = xs + ys + 4                 # (i=1, j=1, k=1) start (unaligned)
    for _ in range(steps):
        # ---------------- force pass ----------------
        with a.repeat(n):                          # i rows:    stride3 = xs
            with a.repeat(n):                      # j columns: stride2 = ys
                with a.repeat(chunks):
                    a.vmv(FX, ZR); a.vmv(FY, ZR); a.vmv(FZ, ZR)
                    a.vle(CX, ap[0] + off, stride=32, stride2=ys, stride3=xs)
                    a.vle(CY, ap[1] + off, stride=32, stride2=ys, stride3=xs)
                    a.vle(CZ, ap[2] + off, stride=32, stride2=ys, stride3=xs)
                    for d in nbr_off:
                        a.vle(NX, ap[0] + off + d, stride=32, stride2=ys,
                              stride3=xs)
                        a.vle(NY, ap[1] + off + d, stride=32, stride2=ys,
                              stride3=xs)
                        a.vle(NZ, ap[2] + off + d, stride=32, stride2=ys,
                              stride3=xs)
                        a.vsub(DX, NX, CX)
                        a.vsub(DY, NY, CY)
                        a.vsub(DZ, NZ, CZ)
                        a.vmul(T1, DX, DX)
                        a.vmacc(T1, DY, DY)
                        a.vmacc(T1, DZ, DZ)
                        a.vsqrt(T1, T1)            # dist
                        a.vadd_sc(T2, T1, -L0)     # dist - L0
                        a.vmul_sc(T2, T2, K_SPRING)
                        a.vdiv(T2, T2, T1)         # K*(dist-L0)/dist
                        a.vmacc(FX, T2, DX)
                        a.vmacc(FY, T2, DY)
                        a.vmacc(FZ, T2, DZ)
                    a.vse(FX, af[0] + off, stride=32, stride2=ys, stride3=xs)
                    a.vse(FY, af[1] + off, stride=32, stride2=ys, stride3=xs)
                    a.vse(FZ, af[2] + off, stride=32, stride2=ys, stride3=xs)
                    a.scalar(4)
                a.scalar(3)
        # ---------------- integrate pass ----------------
        with a.repeat(n):
            with a.repeat(n):
                with a.repeat(chunks):
                    for c in range(3):
                        a.vle(1, af[c] + off, stride=32, stride2=ys,
                              stride3=xs)                    # F
                        a.vle(2, av[c] + off, stride=32, stride2=ys,
                              stride3=xs)                    # v
                        a.vmacc(2, DTR, 1)                   # v += dt*F
                        a.vse(2, av[c] + off, stride=32, stride2=ys,
                              stride3=xs)
                        a.vle(3, ap[c] + off, stride=32, stride2=ys,
                              stride3=xs)                    # p
                        a.vmacc(3, DTR, 2)                   # p += dt*v
                        a.vse(3, ap[c] + off, stride=32, stride2=ys,
                              stride3=xs)
                    a.scalar(4)
                a.scalar(3)
    prog = a.finalize(mm)

    # ------------------- f64 mirror -------------------
    P = pos.astype(np.float64)
    V = vel.astype(np.float64)
    F = frc.astype(np.float64)
    sl = (slice(1, n + 1), slice(1, n + 1), slice(1, n + 1))

    def shifted(A, d):
        ax = {0: (1, 0, 0), 1: (-1, 0, 0), 2: (0, 1, 0),
              3: (0, -1, 0), 4: (0, 0, 1), 5: (0, 0, -1)}[d]
        return A[:, 1 + ax[0]:n + 1 + ax[0], 1 + ax[1]:n + 1 + ax[1],
                 1 + ax[2]:n + 1 + ax[2]]

    for _ in range(steps):
        acc = np.zeros((3, n, n, n))
        for d in range(6):
            diff = shifted(P, d) - P[:, sl[0], sl[1], sl[2]]
            dist = np.sqrt((diff ** 2).sum(axis=0))
            coef = K_SPRING * (dist - L0) / dist
            acc += coef * diff
        F[:, sl[0], sl[1], sl[2]] = acc
        V[:, sl[0], sl[1], sl[2]] += DT * F[:, sl[0], sl[1], sl[2]]
        P[:, sl[0], sl[1], sl[2]] += DT * V[:, sl[0], sl[1], sl[2]]

    expected = {}
    for i, c in enumerate("xyz"):
        expected[f"pos{c}"] = P[i].astype(np.float32)
        expected[f"vel{c}"] = V[i].astype(np.float32)
    return common.Built(prog, expected, rtol=2e-4, atol=1e-5)


def scalar_cost(n=32, steps=2, **_) -> ScalarCost:
    pts = steps * n ** 3
    # per point per neighbour: 9 flops + fsqrt(~12cyc=6 flop-equiv) +
    # fdiv(~12) + 3 lw; plus integration (6 flops, 9 mem ops).
    return ScalarCost(flop_ops=pts * (6 * 21 + 6),
                      loads=pts * (6 * 3 + 6), stores=pts * 9,
                      unique_lines=steps * 9 * n * n * _zpad(n) // 8,
                      loop_iters=pts * 2)
