"""Analytic hardware area/power model for the cVRF study.

The paper's area/power numbers come from 28 nm synthesis (Cadence flow) of
the Codasip L31 + VPU; synthesis is impossible in this container, so we use
the standard architectural substitute: a component-level area model in
arbitrary calibrated *area units* (au).

Model structure (see Fig 2 / Fig 7 / §4.4.1):
    VPU(n)  = n*REG_AU + ALU0_AU + n*COUPLE_AU  [+ OV(n) if dispersed]
    total   = VPU + SCALAR_AU
  - n*REG_AU      : register storage incl. its port wiring (per register)
  - n*COUPLE_AU   : VRF<->ALU crossbar/routing on the ALU side; this term is
                    what lets the measured VPU saving (53%) exceed the pure
                    VRF-share bound (61% x (1-1/3.5) = 43.6%) — compacting
                    the VRF also shrinks the datapath routing, exactly the
                    congestion effect the paper shows in Fig 7.
  - OV(n)         : dispersion overhead (tag array + comparators + control)
  - dispersed adds one pinned v0 register (n_eff = n + 1).

Calibration: REG_AU+... are solved in closed form from exactly three
published *baseline-and-headline* constraints —
    (1) VRF = 61% of VPU (Fig 2),
    (2) VRF area reduction = 3.5x (§4.4.1),
    (3) VPU area saving = 53% (§4.4.1);
SCALAR_AU then follows from 53% -> 23% total.  The model's *untuned
predictions* (the 23% total, per-width scaling used in Fig 6, per-app power
of Fig 8) are the reproduction, checked in benchmarks/.

Power: dynamic event energies scale with the exercised block's size (VRF
access energy grows with register count - mux depth & bitline load), plus
clock tree (~FF bits) and leakage (~area); activity counts come from the
cycle simulator, so per-application power is simulation-driven.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import isa

VLEN = isa.VLEN_BITS

# --------------------------------------------------------------------------
# Calibrated constants (closed-form solution of the three constraints).
# --------------------------------------------------------------------------
REG_AU_PER_BIT = 8372.0 / VLEN       # storage + port wiring, per bit
COUPLE_AU_PER_BIT = 1800.4 / VLEN    # VRF<->ALU crossbar, per bit per reg
ALU0_AU = 113670.0                   # 8-lane vector ALU (32b int+bf16 FMA)
TAG_AU_PER_SLOT = 37.0               # 5b tag + valid + dirty + comparator
CTRL_AU = 900.0                      # dispersion control unit / uop FSM
SCALAR_AU = 572749.0                 # L31 scalar core incl. FPU + 2 RFs
# 6T SRAM macro density, for the beyond-paper L1-inclusive trade-off
# (the paper's Fig 2/7 areas exclude L1 macros; the Pareto-frontier study
# and the cluster iso-SRAM-budget sweeps need cache capacity on the same
# axis as the VRF).  Anchor: published 28 nm planar 6T bitcells are
# ~0.12-0.127 um^2 (e.g. TSMC 28 nm HPM as reported in ISSCC'11-era SRAM
# papers), and assembled macros land at ~2x the raw bitcell array once
# decoders/sense-amps/redundancy are in (the periphery constant below).
# The paper gives no absolute um^2 for its flop VRF, only ratios, so the
# calibrated REG_AU_PER_BIT fixes the au scale; a flop + mux/clock load
# in 28 nm is ~4x a 6T bitcell in drawn area, hence the /4.  The old
# TODO(cal) is closed by ``repro_torch.silicon``: these two constants are now
# the pinned derivation of the default ``flop`` macro model (bit-identical
# to this closed form), and per-geometry OpenRAM-style curves
# (``sram6t`` / ``table``) are swappable behind ``l1_sram_area(macro=)``
# and the ``macro_model`` parameter of the area/energy metrics.
SRAM_AU_PER_BIT = REG_AU_PER_BIT / 4.0
SRAM_PERIPHERY_AU = 9000.0           # decoders + sense amps + tag array


@dataclasses.dataclass
class AreaReport:
    vrf: float                        # registers + their routing
    coupling: float                   # VRF<->ALU crossbar share
    vpu_alu: float
    dispersion_overhead: float
    scalar_core: float

    @property
    def vpu(self) -> float:
        return (self.vrf + self.coupling + self.vpu_alu
                + self.dispersion_overhead)

    @property
    def total(self) -> float:
        return self.vpu + self.scalar_core

    def as_dict(self) -> dict:
        return dict(vrf=self.vrf, coupling=self.coupling,
                    vpu_alu=self.vpu_alu,
                    dispersion_overhead=self.dispersion_overhead,
                    scalar_core=self.scalar_core, vpu=self.vpu,
                    total=self.total)


def cpu_area(n_vregs: int, vlen_bits: int = VLEN, n_lanes: int = 8,
             dispersed: bool = False) -> AreaReport:
    """CPU+VPU logic area (excluding L1 SRAM macros, as Fig 7)."""
    n_eff = n_vregs + (1 if dispersed else 0)      # pinned v0
    vrf = n_eff * vlen_bits * REG_AU_PER_BIT
    couple = n_eff * vlen_bits * COUPLE_AU_PER_BIT
    alu = ALU0_AU * (n_lanes / 8.0)
    over = (n_vregs * TAG_AU_PER_SLOT + CTRL_AU) if dispersed else 0.0
    return AreaReport(vrf=vrf, coupling=couple, vpu_alu=alu,
                      dispersion_overhead=over, scalar_core=SCALAR_AU)


def cpu_area_grid(n_vregs, vlen_bits: int = VLEN, n_lanes: int = 8,
                  dispersed=False) -> dict:
    """Vectorized :func:`cpu_area`: ``n_vregs`` / ``dispersed`` may be
    ndarrays (broadcast together) and every component comes back as an
    array of the broadcast shape.  Operation order mirrors the scalar path
    exactly, so grid entries are bit-equal to per-point ``cpu_area`` calls
    (pinned by ``tests/test_metrics.py``)."""
    n_vregs = np.asarray(n_vregs, np.int64)
    dispersed = np.asarray(dispersed, bool)
    n_vregs, dispersed = np.broadcast_arrays(n_vregs, dispersed)
    n_eff = n_vregs + dispersed                       # pinned v0
    vrf = n_eff * vlen_bits * REG_AU_PER_BIT
    couple = n_eff * vlen_bits * COUPLE_AU_PER_BIT
    alu = np.broadcast_to(
        np.asarray(ALU0_AU * (n_lanes / 8.0)), n_vregs.shape)
    over = np.where(dispersed, n_vregs * TAG_AU_PER_SLOT + CTRL_AU, 0.0)
    scalar = np.broadcast_to(np.asarray(SCALAR_AU), n_vregs.shape)
    vpu = vrf + couple + alu + over
    return dict(vrf=vrf, coupling=couple, vpu_alu=alu,
                dispersion_overhead=over, scalar_core=scalar, vpu=vpu,
                total=vpu + scalar)


def l1_sram_area(sets, ways, line_bytes: int = 32, macro=None):
    """L1 data-cache macro area (beyond-paper; excluded from Fig 2/7).
    Vectorized over ``sets``/``ways`` arrays.

    ``macro`` selects a :mod:`repro_torch.silicon` macro model (a registry name
    or a ``MacroModel`` instance) pricing the ``sets * ways`` lines x
    ``line_bytes * 8``-bit geometry; ``None`` keeps the legacy closed
    form, which IS the ``flop`` backend (bit-identical, pinned in
    ``tests/test_silicon.py``)."""
    if macro is not None:
        from repro_torch import silicon   # lazy: silicon sits above the core
        model = silicon.get_macro_model(macro)
        return model.area(
            np.asarray(sets, np.int64) * np.asarray(ways, np.int64),
            line_bytes * 8)
    bits = np.asarray(sets, np.int64) * np.asarray(ways, np.int64) \
        * (line_bytes * 8)
    return bits * SRAM_AU_PER_BIT + SRAM_PERIPHERY_AU


# --------------------------------------------------------------------------
# Analytic cross-check of traced machine-axis sweeps.
# --------------------------------------------------------------------------

# Counters that latency parameters may change.  Everything else is decided
# by the replacement machinery, whose metadata is slot-grid-timestamped and
# therefore machine-latency-invariant.
TIMING_COUNTERS = ("cycles", "stall_cycles")


def check_machine_affine(counters: dict, machines, timing=TIMING_COUNTERS,
                         mem_slope_floor=None) -> dict:
    """Analytic conformance check of a machine-swept counter grid.

    The simulator's latency parameters (``l1_hit_cycles``,
    ``uop_hit_cycles``, ``mem_latency``) enter only the cycle arithmetic,
    never a hit/miss/eviction decision, so for counters on a trailing
    machine axis of M points (from ``simulate_grid(..., MachineSweep)``):

      * every non-timing counter must be *constant* along the machine axis;
      * ``cycles`` and ``stall_cycles`` must be exactly affine in the three
        latencies, with non-negative integer coefficients; the
        ``mem_latency`` coefficient counts memory transfers, so it is at
        least ``l1_misses`` (writebacks add to it).

    Raises AssertionError (explicitly, so the check survives ``python -O``)
    on any violation; returns the integer coefficient arrays ``{counter:
    (const, a_l1hit, a_uop, a_mem)}`` with leading shape equal to the
    grid's non-machine dimensions.  A latency held constant across the
    sweep is not identifiable: its coefficient is reported as 0 and its
    contribution folds into ``const``.  This is the closed-form cross-check
    that a traced machine sweep agrees with the per-point machine model —
    no re-simulation needed.

    ``timing`` names the counters the latencies may change (default
    :data:`TIMING_COUNTERS`; the cluster engine adds
    ``contention_stalls``), and ``mem_slope_floor`` overrides the default
    ``l1_misses`` floor on the ``mem_latency`` slope of ``cycles`` — a
    shared L2 converts hits into static-latency transfers, so cluster
    counters pass ``l1_misses - l2_hits`` (see
    :func:`repro_torch.cluster.engine.check_cluster_affine`).
    """
    M = len(machines)
    axes = (np.ones(M), np.asarray(machines.l1_hit_cycles, np.float64),
            np.asarray(machines.uop_hit_cycles, np.float64),
            np.asarray(machines.mem_latency, np.float64))
    # Only the intercept plus latencies that actually vary enter the fit;
    # a constant column would make the design rank-deficient and let the
    # min-norm solution smear the intercept into meaningless slopes.
    ident = [0] + [i for i in (1, 2, 3) if np.unique(axes[i]).size > 1]
    design = np.stack([axes[i] for i in ident], axis=1)     # (M, k)
    if np.linalg.matrix_rank(design) < len(ident):
        raise AssertionError(
            "machine sweep axes are collinear — per-latency coefficients "
            "are not identifiable; decorrelate the sweep grid")
    for name, v in counters.items():
        if name in timing or name in ("hit_rate", "event_scale",
                                      "fold_exact"):
            continue
        v = np.asarray(v)
        if not (v == v[..., :1]).all():
            raise AssertionError(
                f"counter {name!r} varies along the machine axis — latency "
                "parameters leaked into a replacement decision")
    coeffs = {}
    pinv = np.linalg.pinv(design)                     # (k, M)
    for name in timing:
        y = np.asarray(counters[name], np.float64)    # (..., M)
        c = np.einsum("km,...m->...k", pinv, y)       # (..., k)
        resid = np.einsum("mk,...k->...m", design, c) - y
        if not np.abs(resid).max() < 0.5:
            raise AssertionError(
                f"counter {name!r} is not affine in the machine latencies "
                f"(max residual {np.abs(resid).max():.3f})")
        full = np.zeros(y.shape[:-1] + (4,))
        full[..., ident] = c
        coeffs[name] = np.rint(full).astype(np.int64)
    # The mem_latency slope of total cycles counts memory transfers:
    # >= l1_misses, identifiable only when the sweep varies mem_latency.
    if 3 in ident:
        slope = coeffs["cycles"][..., 3]
        if mem_slope_floor is None:
            mem_slope_floor = np.asarray(counters["l1_misses"])[..., 0]
        if not (slope >= np.asarray(mem_slope_floor)).all():
            raise AssertionError(
                "cycles' mem_latency slope fell below its transfer floor "
                "(l1_misses, or l1_misses - l2_hits for clusters)")
    return coeffs


# --------------------------------------------------------------------------
# Power model.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PowerParams:
    """Per-event dynamic energies (pJ-equivalent) and static coefficients."""

    e_vrf_access_per_reg: float = 0.02   # per resident register per access
    e_alu_op: float = 14.0               # one 8-lane vector op
    e_scalar_op: float = 6.0
    e_l1_access: float = 12.0            # 32 B L1 hit
    e_mem_access: float = 70.0           # 32 B main-memory transfer
    leak_per_au: float = 1e-5            # static power per area unit
    clock_per_ff_bit: float = 0.0005     # clock tree per FF bit
    p_base: float = 30.0                 # fetch/PLL/IO floor (VRF-invariant)


DEFAULT_POWER = PowerParams()


def application_power(counters: dict, n_vregs: int, cycles: float,
                      n_lanes: int = 8, dispersed: bool = False,
                      pp: PowerParams = DEFAULT_POWER) -> dict:
    """Average-power estimate for one application run (model units).

    ``counters`` from ``simulator.simulate_*``: the hit/miss/spill/fill
    traffic the mechanism adds is charged at L1/memory energy, so the
    power saving is a *net* of smaller-VRF gains minus dispersion traffic.
    """
    area = cpu_area(n_vregs, n_lanes=n_lanes, dispersed=dispersed)
    n_eff = n_vregs + (1 if dispersed else 0)
    reg_ev = float(counters["reg_reads"] + counters["reg_writes"])
    l1_ev = float(counters["l1_hits"] + counters["mem_reads"]
                  + counters["mem_writes"])
    mem_ev = float(counters["l1_misses"])
    alu_ev = float(counters["reg_writes"])
    cyc = max(float(counters["cycles"]), 1.0)

    dyn = (reg_ev * pp.e_vrf_access_per_reg * n_eff
           + alu_ev * pp.e_alu_op
           + cyc * 0.35 * pp.e_scalar_op
           + l1_ev * pp.e_l1_access
           + mem_ev * pp.e_mem_access) / cyc
    clock = n_eff * VLEN * pp.clock_per_ff_bit
    leak = area.total * pp.leak_per_au
    return dict(dynamic=dyn, clock=clock, leakage=leak, base=pp.p_base,
                total=pp.p_base + dyn + clock + leak)


def application_power_grid(counters: dict, n_vregs, n_lanes: int = 8,
                           dispersed=False,
                           pp: PowerParams = DEFAULT_POWER) -> dict:
    """Vectorized :func:`application_power` over a whole counter grid.

    ``counters`` holds counter-name -> ndarray grids (e.g. straight from a
    :class:`repro_torch.api.SweepResult`); ``n_vregs`` / ``dispersed``
    broadcast
    against them.  Term order mirrors the scalar path exactly, so every
    grid entry is bit-equal to a per-point ``application_power`` call
    (pinned by ``tests/test_metrics.py``) — this is what replaced fig8's
    per-application Python loop."""
    n_vregs = np.asarray(n_vregs, np.int64)
    dispersed = np.asarray(dispersed, bool)
    area_total = cpu_area_grid(n_vregs, n_lanes=n_lanes,
                               dispersed=dispersed)["total"]
    n_eff = n_vregs + dispersed
    as_f = lambda v: np.asarray(v, np.float64)  # noqa: E731
    reg_ev = as_f(counters["reg_reads"] + counters["reg_writes"])
    l1_ev = as_f(counters["l1_hits"] + counters["mem_reads"]
                 + counters["mem_writes"])
    mem_ev = as_f(counters["l1_misses"])
    alu_ev = as_f(counters["reg_writes"])
    cyc = np.maximum(as_f(counters["cycles"]), 1.0)

    dyn = (reg_ev * pp.e_vrf_access_per_reg * n_eff
           + alu_ev * pp.e_alu_op
           + cyc * 0.35 * pp.e_scalar_op
           + l1_ev * pp.e_l1_access
           + mem_ev * pp.e_mem_access) / cyc
    clock = n_eff * VLEN * pp.clock_per_ff_bit
    leak = area_total * pp.leak_per_au
    total = pp.p_base + dyn + clock + leak
    base = np.asarray(pp.p_base)
    dyn, clock, leak, base, total = np.broadcast_arrays(
        dyn, clock, leak, base, total)
    return dict(dynamic=dyn, clock=clock, leakage=leak, base=base,
                total=total)
