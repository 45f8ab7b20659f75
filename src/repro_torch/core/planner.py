"""Working-set planning on top of the cycle simulator.

Turns the paper's Fig 5 analysis into an API: given a kernel's trace, find
the minimum cVRF capacity achieving a target hit rate (the paper uses >95%),
and quantify the headroom of smarter replacement policies (beyond-paper).
The engine runs on the card unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import policies, simulator
from repro_torch.core.trace import Program


@dataclasses.dataclass
class PlanResult:
    min_capacity: int
    hit_rates: dict[int, float]            # capacity -> hit rate
    cycles: dict[int, int]                 # capacity -> cycles
    full_vrf_cycles: int
    active_regs: int


def min_registers_for_hit_rate(
    program: Program,
    target: float = 0.95,
    capacities=tuple(range(3, 17)),
    policy: int = policies.FIFO,
    machine: simulator.MachineParams = simulator.DEFAULT_MACHINE,
    max_events: int | None = None,
    fold: bool = False,
    device="cuda",
) -> PlanResult:
    """Smallest capacity whose operand hit rate exceeds ``target``.

    ``program`` may be a Program, a pre-expanded EventStream, or a
    PreparedTrace (e.g. a folded trace prepared once).
    """
    prep = simulator.prepare(program, fold=fold, max_events=max_events,
                             machine=machine)
    caps = list(capacities) + [32]
    sweep = simulator.SweepConfig.make(caps, policy)
    out = simulator.simulate_grid([prep], sweep, machine, device=device)
    hit = {c: float(h) for c, h in zip(caps, out["hit_rate"][0])}
    cyc = {c: int(x) for c, x in zip(caps, out["cycles"][0])}
    ok = [c for c in capacities if hit[c] > target]
    active = (len(program.active_vregs())
              if isinstance(program, Program) else -1)
    return PlanResult(
        min_capacity=min(ok) if ok else max(capacities) + 1,
        hit_rates=hit, cycles=cyc, full_vrf_cycles=cyc[32],
        active_regs=active,
    )


def policy_headroom(program: Program, capacities=tuple(range(3, 9)),
                    max_events: int | None = None,
                    fold: bool = False, device="cuda") -> dict:
    """Hit-rate comparison FIFO vs LRU vs LFU vs OPT (beyond-paper study).

    OPT (Belady) upper-bounds any realizable policy; the gap FIFO->OPT is the
    headroom the paper left on the table by choosing the cheapest policy.
    One grid call sweeps the full capacities x policies product.
    """
    prep = simulator.prepare(program, fold=fold, max_events=max_events)
    pols = (policies.FIFO, policies.LRU, policies.LFU, policies.OPT)
    sweep = simulator.SweepConfig.product(list(capacities), pols)
    res = simulator.simulate_grid([prep], sweep, device=device)
    out = {}
    for li, pol in enumerate(pols):
        out[policies.POLICY_NAMES[pol]] = {
            int(c): float(res["hit_rate"][0, ci * len(pols) + li])
            for ci, c in enumerate(capacities)}
    return out


def normalized_performance(program: Program, capacities,
                           policy: int = policies.FIFO,
                           max_events: int | None = None,
                           device="cuda") -> dict[int, float]:
    """Fig 4(a): performance of each capacity normalized to the full VRF
    (1.0 = no slowdown; <1.0 = dispersion stalls hurt)."""
    caps = list(capacities) + [32]
    sweep = simulator.SweepConfig.make(caps, policy)
    prep = simulator.prepare(program, max_events=max_events)
    out = simulator.simulate_grid([prep], sweep, device=device)
    full = float(out["cycles"][0, -1])
    return {int(c): full / float(x)
            for c, x in zip(caps[:-1], out["cycles"][0, :-1])}
