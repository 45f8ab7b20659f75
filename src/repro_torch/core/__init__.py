"""Register Dispersion core: the paper's contribution as composable
modules, ported from the reference's ``core`` package module for module.

Public API:
  trace.Assembler / trace.MemoryMap / trace.Program   — RVV-lite trace eDSL
  interpreter.run / interpreter.run_dispersed          — functional oracles
  simulator.prepare / simulate_grid / simulate_one     — cycle-level cVRF
                                                        model (K1 on the
                                                        card, its twin on
                                                        the CPU)
  simulator.MachineSweep                               — machine axes
  folding.plan                                         — exact periodic folding
  policies.FIFO / LRU / LFU / OPT                      — replacement policies
  planner.min_registers_for_hit_rate / policy_headroom — working-set planning
"""

from repro_torch.core import (events, folding, interpreter, isa, planner,
                              policies, simulator, trace)
from repro_torch.core.simulator import (MachineParams, MachineSweep,
                                        PreparedTrace, SweepConfig, prepare,
                                        simulate_grid, simulate_one)
from repro_torch.core.trace import Assembler, MemoryMap, Program

__all__ = [
    "events", "folding", "interpreter", "isa", "planner", "policies",
    "simulator", "trace", "MachineParams", "MachineSweep", "PreparedTrace",
    "SweepConfig", "prepare", "simulate_grid", "simulate_one", "Assembler",
    "MemoryMap", "Program",
]
