"""Cycle-level cVRF / Register Dispersion simulator.

Models the paper's microarchitecture (§3, Table 1):

  * compact VRF of ``capacity`` physical 256-bit registers, fully associative,
    tag array checked serially per operand, FIFO (or alternative) replacement;
  * ``v0`` pinned outside the cVRF (its accesses never reach the tag array);
  * every architectural register has a reserved memory address; spills/fills
    are 32-byte transfers through the modelled L1D (16 KB, 2-way, 32 B lines,
    1-cycle hit) backed by a 5-cycle main memory;
  * vector loads/stores share the same L1 port (integrated VPU, Fig 1);
  * a full-size VRF baseline (``capacity >= 32``) in which every operand
    access hits and no fills ever occur.

The port of the reference's ``core/simulator.py``.  Trace preparation
(:func:`prepare`, optional exact periodic folding by ``core.folding``) and
the (P, C, M) grid's bookkeeping are numpy, as in the reference.  The
engine itself, one walk over the instruction rows per (program, config,
machine) lane, is ``kernels/engine_scan.py``: K1, a hand-written CUDA
kernel, on the card (the default of every entry point here), and its
plain-torch twin on the CPU (``device="cpu"``).  The reference's
``compile_count``/``dispatch_count`` are XLA notions with no counterpart;
the port's probe is K1's launch count (``engine_scan_cuda.launches``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import events as ev_mod
from repro_torch.core import folding, isa, policies
from repro_torch.core.events import NO_NEXT_USE, EventStream
from repro_torch.kernels import engine_scan as k1
from repro_torch.device import resolve_device

# ---------------------------------------------------------------------------
# Machine parameters (Table 1): L1 geometry + per-lane latency axes.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MachineParams:
    """One machine point.  ``l1_sets``/``l1_ways`` size the L1 state
    arrays; the three latency fields are per-lane inputs of the engine, so
    machines sharing a geometry share one engine run."""

    l1_sets: int = 256            # 16 KB / 32 B lines / 2 ways
    l1_ways: int = 2
    l1_hit_cycles: int = 0        # data-path hits overlap the vector pipe
    uop_hit_cycles: int = 1       # spill/fill micro-ops serialize in ID
    mem_latency: int = 5          # main memory @200 MHz (Table 1: 1-5 cycles)


DEFAULT_MACHINE = MachineParams()


@dataclasses.dataclass
class MachineSweep:
    """Machine sweep axis: M latency points over one L1 geometry.  The
    latency arrays are a batch axis of the engine's lanes, so the whole
    machine grid runs together."""

    l1_hit_cycles: np.ndarray     # (M,) int32 data-path L1 hit cycles
    uop_hit_cycles: np.ndarray    # (M,) int32 spill/fill uop hit cycles
    mem_latency: np.ndarray       # (M,) int32 main-memory latency
    l1_sets: int = 256            # static: L1 state shape
    l1_ways: int = 2              # static: L1 state shape

    @staticmethod
    def make(mem_latency, l1_hit_cycles=0, uop_hit_cycles=1,
             l1_sets=256, l1_ways=2) -> "MachineSweep":
        mem = np.atleast_1d(np.asarray(mem_latency, np.int32))
        l1h = np.broadcast_to(np.asarray(l1_hit_cycles, np.int32),
                              mem.shape).copy()
        uop = np.broadcast_to(np.asarray(uop_hit_cycles, np.int32),
                              mem.shape).copy()
        return MachineSweep(l1h, uop, mem, l1_sets, l1_ways)

    @staticmethod
    def product(mem_latencies, l1_hit_cycles=(0,), uop_hit_cycles=(1,),
                l1_sets=256, l1_ways=2) -> "MachineSweep":
        """Cartesian latency grid as one machine axis (parameter order
        mirrors :meth:`make`)."""
        mem, l1h, uop = [], [], []
        for m in mem_latencies:
            for h in l1_hit_cycles:
                for u in uop_hit_cycles:
                    mem.append(m), l1h.append(h), uop.append(u)
        return MachineSweep(np.asarray(l1h, np.int32),
                            np.asarray(uop, np.int32),
                            np.asarray(mem, np.int32), l1_sets, l1_ways)

    @staticmethod
    def from_params(points) -> "MachineSweep":
        """Stack MachineParams points (which must share an L1 geometry)."""
        points = list(points)
        geo = {(p.l1_sets, p.l1_ways) for p in points}
        if len(geo) != 1:
            raise ValueError(
                f"machine points mix L1 geometries {sorted(geo)}; "
                "l1_sets/l1_ways are static (they size the L1 arrays) — "
                "sweep them in an outer loop")
        return MachineSweep(
            np.asarray([p.l1_hit_cycles for p in points], np.int32),
            np.asarray([p.uop_hit_cycles for p in points], np.int32),
            np.asarray([p.mem_latency for p in points], np.int32),
            points[0].l1_sets, points[0].l1_ways)

    def point(self, m: int) -> MachineParams:
        """The m-th machine point as a scalar MachineParams."""
        return MachineParams(self.l1_sets, self.l1_ways,
                             int(self.l1_hit_cycles[m]),
                             int(self.uop_hit_cycles[m]),
                             int(self.mem_latency[m]))

    def __len__(self):
        return len(self.mem_latency)


COUNTER_NAMES = (
    "cycles", "stall_cycles", "vrf_hits", "vrf_misses", "spills", "fills",
    "l1_hits", "l1_misses", "reg_reads", "reg_writes", "mem_reads",
    "mem_writes",
)


@dataclasses.dataclass
class SweepConfig:
    """Per-configuration sweep axes (arrays of equal length C)."""

    capacity: np.ndarray        # physical registers in the cVRF
    policy: np.ndarray          # policies.FIFO / LRU / LFU / OPT
    alloc_no_fetch: np.ndarray  # beyond-paper: skip fetch on full overwrite

    @staticmethod
    def make(capacities, policy=policies.FIFO, alloc_no_fetch=False):
        caps = np.asarray(capacities, np.int32)
        pol = np.broadcast_to(np.asarray(policy, np.int32), caps.shape).copy()
        anf = np.broadcast_to(np.asarray(alloc_no_fetch, bool),
                              caps.shape).copy()
        return SweepConfig(caps, pol, anf)

    @staticmethod
    def product(capacities, policies_, alloc_no_fetch=(False,)):
        """Cartesian grid capacities x policies x anf as one config axis."""
        caps, pols, anfs = [], [], []
        for c in capacities:
            for p in policies_:
                for a in alloc_no_fetch:
                    caps.append(c), pols.append(p), anfs.append(a)
        return SweepConfig(np.asarray(caps, np.int32),
                           np.asarray(pols, np.int32),
                           np.asarray(anfs, bool))

    def __len__(self):
        return len(self.capacity)


# L1 access sites one instruction can touch, in engine order: (spill, fill)
# per REG slot 0..2, then the two MEM lanes (the per-core L1-miss stream a
# cluster's shared L2 consumes).
NUM_MISS_SITES = 8


# ---------------------------------------------------------------------------
# Trace preparation: expansion + optional periodic folding / truncation.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PreparedTrace:
    """An expanded (and possibly folded / truncated) trace, ready to grid."""

    ev: EventStream
    weight: np.ndarray        # (T',) int32 extrapolation weights (ones if
    wa: np.ndarray            # unfolded); wa/wb pick out the two measured
    wb: np.ndarray            # periods whose equality certifies exactness
    num_folds: int
    event_scale: float        # >1 when prefix-truncated via max_events
    spill_line0: int
    certifiable: bool = True  # False: post-fold rows reuse dropped lines,
    #   so A == B cannot certify exactness (folding.FoldPlan.certifiable)

    @property
    def num_rows(self) -> int:
        return self.ev.num_instructions


def _slice_prep(prep: PreparedTrace, t: int) -> PreparedTrace:
    ev = prep.ev
    sliced = EventStream(
        reg_valid=ev.reg_valid[:t], reg=ev.reg[:t],
        vd_writes=ev.vd_writes[:t], vd_reads=ev.vd_reads[:t],
        vd_no_fetch=ev.vd_no_fetch[:t], lock_vs1=ev.lock_vs1[:t],
        lock_vs2=ev.lock_vs2[:t], mem_valid=ev.mem_valid[:t],
        mem_line=ev.mem_line[:t], mem_write=ev.mem_write[:t],
        cost=ev.cost[:t], next_use=ev.next_use[:t],
        events_per_row=ev.events_per_row[:t],
        spill_line0=ev.spill_line0, num_instructions=t, repeats=[],
    )
    return dataclasses.replace(prep, ev=sliced, weight=prep.weight[:t],
                               wa=prep.wa[:t], wb=prep.wb[:t])


def prepare(program_or_events, fold: bool = False,
            max_events: int | None = None,
            warm_lines: int | None = None,
            machine=None) -> PreparedTrace:
    """Expand a trace once; optionally fold its periodic loops (exact for
    steady-state traces) or truncate it to ``max_events`` flat events at an
    instruction boundary (approximate, the legacy prefix mode).

    The two modes are mutually exclusive: truncating a folded trace would
    drop the extrapolation-weighted measured periods and corrupt both the
    counters and the exactness certificate, so ``max_events`` forces
    ``fold`` off.

    ``machine`` (a :class:`MachineParams` or :class:`MachineSweep`) sizes
    the fold warm-up to the L1 geometry the trace will be swept on (2x its
    line count, see ``folding.warm_lines_for``); the latency axes never
    affect preparation.  An explicit ``warm_lines`` wins.
    """
    if isinstance(program_or_events, PreparedTrace):
        return program_or_events
    if warm_lines is None:
        geo = machine if machine is not None else DEFAULT_MACHINE
        warm_lines = folding.warm_lines_for(geo.l1_sets, geo.l1_ways)
    if max_events is not None:
        fold = False
    plan = None
    if isinstance(program_or_events, EventStream):
        if fold:
            # Fold planning needs the Program (warm-up sizing reads the raw
            # address stream); refusing beats silently scanning in full.
            raise ValueError(
                "fold=True requires a Program (or a PreparedTrace from "
                "prepare(program, fold=True)), not a pre-expanded "
                "EventStream")
        ev = program_or_events
    else:
        if fold:
            plan = folding.plan(program_or_events, warm_lines=warm_lines)
        ev = ev_mod.expand(
            program_or_events, rows=plan.rows if plan else None)
    T = ev.num_instructions
    if plan is not None:
        prep = PreparedTrace(ev, plan.weight, plan.wa, plan.wb,
                             plan.num_folds, 1.0, ev.spill_line0,
                             certifiable=plan.certifiable)
    else:
        ones = np.ones(T, np.int32)
        zeros = np.zeros(T, np.int32)
        prep = PreparedTrace(ev, ones, zeros, zeros, 0, 1.0, ev.spill_line0)
    total = ev.num_events
    if max_events is not None and total > max_events:
        cum = np.cumsum(ev.events_per_row)
        t = max(int(np.searchsorted(cum, max_events, side="right")), 1)
        prep = _slice_prep(prep, t)
        prep.event_scale = total / float(cum[t - 1])
    return prep


def _stack(preps: list[PreparedTrace], pad_to: int | None = None):
    """The engine's 15 event arrays, (P, T) or (P, T, k) each, and the P
    spill lines.  Traces are padded to ``pad_to`` rows, by default to the
    longest (the reference's power-of-two buckets serve XLA's compiled
    shapes, which the port has not)."""
    t_pad = pad_to or max(max(p.num_rows for p in preps), 1)

    def pad(get, fill, dtype=None):
        outs = []
        for pr in preps:
            a = get(pr)
            if a.ndim == 1:
                full = np.full(t_pad, fill, a.dtype if dtype is None
                               else dtype)
            else:
                full = np.full((t_pad, a.shape[1]), fill,
                               a.dtype if dtype is None else dtype)
            full[: len(a)] = a
            outs.append(full)
        return np.stack(outs)

    arrays = (
        pad(lambda p: p.ev.reg_valid, False),
        pad(lambda p: p.ev.reg, 0),
        pad(lambda p: p.ev.vd_writes, False),
        pad(lambda p: p.ev.vd_reads, False),
        pad(lambda p: p.ev.vd_no_fetch, False),
        pad(lambda p: p.ev.lock_vs1, -1),
        pad(lambda p: p.ev.lock_vs2, -1),
        pad(lambda p: p.ev.mem_valid, False),
        pad(lambda p: p.ev.mem_line, -1),
        pad(lambda p: p.ev.mem_write, False),
        pad(lambda p: p.ev.cost, 0),
        pad(lambda p: p.ev.next_use, NO_NEXT_USE),
        pad(lambda p: p.weight, 0),
        pad(lambda p: p.wa, 0),
        pad(lambda p: p.wb, 0),
    )
    spill0s = np.asarray([p.spill_line0 for p in preps], np.int32)
    return arrays, spill0s


def _run_grid(preps, machine: MachineSweep, cfg, mach, track_ab: bool,
              device):
    """One engine call (K1 on the card, the twin on the CPU) over P
    prepared traces -> (ctr, ctr_a, ctr_b), (P, C, M, 12) int32 numpy.
    Traces are padded to the longest, and each lane walks only its own
    program's rows: the padding rows change no state and no counter."""
    lengths = [p.num_rows for p in preps]
    arrays, spill0s = _stack(preps)
    x = k1.pack(arrays, device)
    out = k1.engine_scan(
        x, torch.as_tensor(spill0s, device=device),
        tuple(torch.as_tensor(a, device=device) for a in cfg),
        tuple(torch.as_tensor(a, device=device) for a in mach),
        l1_sets=machine.l1_sets, l1_ways=machine.l1_ways,
        track_ab=track_ab,
        lengths=torch.as_tensor(lengths, dtype=torch.int32, device=device))
    return tuple(o.cpu().numpy() for o in out)


def simulate_grid(preps: list, sweep: SweepConfig,
                  machine=DEFAULT_MACHINE,
                  batch_programs: bool = False,
                  device="cuda") -> dict[str, np.ndarray]:
    """Simulate P prepared traces under C configurations in one sweep call.

    ``machine`` is either one :class:`MachineParams` point (returns (P, C)
    counter arrays, the classic grid) or a :class:`MachineSweep` of M
    latency points (returns (P, C, M) arrays: the whole machine grid in the
    same engine call).  Alongside the raw counters the dict carries
    ``hit_rate`` and, for folded traces, ``fold_exact`` (measured periods
    A == B => the algebraic extrapolation is exact, certified independently
    at every (C, M) grid point).

    ``batch_programs=True`` runs every trace in one engine call (K1: one
    launch, every lane of every program in parallel; the twin: one walk
    over the longest trace).  The default makes one call per program, so
    no trace is padded to another's length.  ``device`` is where the
    engine runs: ``"cuda"`` (the default) launches K1, ``"cpu"`` runs the
    plain twin.
    """
    dev = resolve_device(device)
    preps = [prepare(p) if not isinstance(p, PreparedTrace) else p
             for p in preps]
    squeeze_m = not isinstance(machine, MachineSweep)
    machines = MachineSweep.from_params([machine]) if squeeze_m else machine
    cfg = (np.asarray(sweep.capacity, np.int32),
           np.asarray(sweep.policy, np.int32),
           np.asarray(sweep.alloc_no_fetch, bool))
    mach = (np.asarray(machines.l1_hit_cycles, np.int32),
            np.asarray(machines.uop_hit_cycles, np.int32),
            np.asarray(machines.mem_latency, np.int32))
    if batch_programs:
        ctr, ctrA, ctrB = _run_grid(preps, machines, cfg, mach,
                                    any(p.num_folds for p in preps), dev)
    else:
        outs = [_run_grid([prep], machines, cfg, mach, prep.num_folds > 0,
                          dev) for prep in preps]
        ctr, ctrA, ctrB = (np.concatenate([o[i] for o in outs])
                           for i in range(3))
    if squeeze_m:
        ctr, ctrA, ctrB = ctr[:, :, 0], ctrA[:, :, 0], ctrB[:, :, 0]
    out = {k: ctr[..., i] for i, k in enumerate(COUNTER_NAMES)}
    grid_shape = out["cycles"].shape              # (P, C) or (P, C, M)
    per_prog = (-1,) + (1,) * (len(grid_shape) - 1)
    if any(p.num_folds for p in preps):
        steady = (ctrA == ctrB).all(axis=-1)
        steady &= np.asarray(
            [p.certifiable for p in preps]).reshape(per_prog)
        unfolded = np.asarray([p.num_folds == 0 for p in preps])
        steady[unfolded] = True
        out["fold_exact"] = steady
    total = out["vrf_hits"] + out["vrf_misses"]
    with np.errstate(divide="ignore", invalid="ignore"):
        out["hit_rate"] = np.where(total > 0, out["vrf_hits"] / total, 1.0)
    out["event_scale"] = np.broadcast_to(
        np.asarray([p.event_scale for p in preps]).reshape(per_prog),
        grid_shape).copy()
    return out


def simulate_one(program, capacity, policy=policies.FIFO,
                 alloc_no_fetch=False,
                 machine=DEFAULT_MACHINE,
                 max_events: int | None = None,
                 fold: bool = False, device="cuda") -> dict[str, float]:
    prep = prepare(program, fold=fold, max_events=max_events,
                   machine=machine)
    sweep = SweepConfig.make([capacity], policy, alloc_no_fetch)
    out = simulate_grid([prep], sweep, machine, device=device)
    return {k: v[0, 0] for k, v in out.items()}


def full_vrf_baseline(program, machine: MachineParams = DEFAULT_MACHINE,
                      max_events: int | None = None,
                      device="cuda") -> dict[str, float]:
    return simulate_one(program, isa.NUM_ARCH_VREGS, machine=machine,
                        max_events=max_events, device=device)


# ---------------------------------------------------------------------------
# Scalar-core baseline (the paper's Table 3 comparison point).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ScalarCost:
    """Analytic cycle model of the -O2 scalar RISC-V version of a kernel.

    On a 3-stage in-order embedded core (Table 1):
      flop_ops:  FPU ops at ``flop_cycles`` each (low-cost FPUs are not
                 fully pipelined; fmadd ~2 cycles effective)
      int_ops:   1-cycle integer ALU ops (incl. branchy min/max selects)
      loads:     ``load_cycles`` each (L1 hit + average load-use hazard)
      stores:    1 cycle
      unique_lines: distinct cachelines -> compulsory-miss stalls
      loop_iters: per-iteration overhead (addr bump + cmp + taken branch;
                 embedded -O2 without aggressive unrolling)
    """

    flop_ops: int = 0
    int_ops: int = 0
    loads: int = 0
    stores: int = 0
    unique_lines: int = 0
    loop_iters: int = 0
    flop_cycles: float = 2.0
    load_cycles: float = 1.5
    overhead_per_iter: int = 3

    def cycles(self, machine=DEFAULT_MACHINE):
        """Scalar-core cycles; with a :class:`MachineSweep` the result is an
        (M,) int64 array over the swept memory latencies."""
        base = (self.flop_ops * self.flop_cycles
                + self.int_ops
                + self.loads * self.load_cycles
                + self.stores
                + self.loop_iters * self.overhead_per_iter)
        mem = self.unique_lines * np.asarray(machine.mem_latency)
        total = base + mem
        if isinstance(machine, MachineSweep):
            return total.astype(np.int64)
        return int(total)
