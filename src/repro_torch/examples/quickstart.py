"""Quickstart: the paper's Register Dispersion study in ~40 lines, on the
port.

Builds the GemV kernel, proves dispersion is semantics-preserving, sweeps
cVRF sizes (Fig 4) through the declarative ``repro_torch.api`` front door
(K1 on the card), finds the minimal working set (Fig 5), and prints the
area/power verdict (Figs 2/8).

  python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch import api, metrics, rvv
from repro_torch.core import interpreter, planner, policies


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    # 1. One Session owns every cache (built kernels, prepared traces) and
    #    plans sweep execution; build a paper kernel at a custom size.
    session = api.Session(device=device)
    built = session.built("gemv", params=dict(m=128, k=256))
    prog = built.program
    print(f"gemv: {prog.num_instructions} instructions, "
          f"{len(prog.active_vregs())} active vector registers")

    # 2. Register Dispersion never changes results (cVRF of 4, FIFO).
    full = interpreter.run(prog)
    rvv.check(built, full.memory)
    disp = interpreter.run_dispersed(prog, capacity=4, policy=policies.FIFO)
    np.testing.assert_array_equal(full.memory, disp.memory)
    print(f"dispersed execution bit-identical "
          f"(hit rate {disp.vrf_hits / (disp.vrf_hits + disp.vrf_misses):.3f})")

    # 3. Fig 4: performance + hit rate vs cVRF size — one declarative sweep.
    caps = [3, 4, 5, 6, 7, 8, 16, 32]
    res = session.run(api.Sweep(kernels=["gemv"], capacity=caps,
                                kernel_params=dict(m=128, k=256)))
    full_cycles = res.value("cycles", capacity=32)
    for c in caps:
        cyc = res.value("cycles", capacity=c)
        bar = "#" * int(40 * full_cycles / cyc)
        print(f"  cVRF {c:2d}: perf {full_cycles / cyc:5.3f} "
              f"hit {res.value('hit_rate', capacity=c):5.3f} {bar}")

    # 4. Fig 5: smallest cVRF with >95% hit rate.
    plan = planner.min_registers_for_hit_rate(prog, device=device)
    print(f"min registers for >95% hit rate: {plan.min_capacity}")

    # 5. Figs 2/8: the hardware verdict for cVRF-8 vs the full VRF — the
    #    area/power models and baseline-relative savings are metrics
    #    evaluated over the sweep grid, not hand-rolled loops.
    head = metrics.area_headline(n_full=32, n_cvrf=8)
    r = (res.derive("savings_pct", of="vpu_area",
                    baseline=dict(capacity=32), out="vpu_area_saving")
            .derive("savings_pct", of="application_power",
                    baseline=dict(capacity=32), out="power_saving")
            .derive("speedup", baseline=dict(capacity=32)))
    print(f"VPU area  -{r.value('vpu_area_saving', capacity=8):.0f}%   "
          f"total area -{head['total_area_saving_pct']:.0f}%   "
          f"power -{r.value('power_saving', capacity=8):.0f}%   "
          f"perf {r.value('speedup', capacity=8):.3f}x")

    # 6. The design-space verdict in one query: the non-dominated
    #    (area, cycles) trade-off over every swept cVRF size.
    front = r.pareto(x="total_area", y="cycles")
    print("area-cycles front:",
          " -> ".join(f"cVRF {f['capacity']} "
                      f"({f['total_area'] / 1e6:.2f}Mau)" for f in front))


if __name__ == "__main__":
    main()
