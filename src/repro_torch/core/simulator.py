"""The cycle-level cVRF / Register Dispersion model: its numpy head.

This is the first piece of the port's ``core/simulator.py``: the machine
parameters of the paper's Table 1 (:class:`MachineParams`,
:data:`DEFAULT_MACHINE`), the machine sweep axis (:class:`MachineSweep`)
and the scalar-core baseline (:class:`ScalarCost`) that the ``rvv``
kernels' ``scalar_cost`` returns.  They are numpy copies of the reference
module's, held equal by ``tests/test_torch_trace.py``.  The engine itself
(``prepare``, ``simulate_grid``, the per-instruction scan and its CUDA
kernel) comes with the next slice of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np

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
