"""Beyond-paper analysis, on the port: replacement-policy headroom and the
accumulator working-set analogue one level up (on-chip tiles vs memory
traffic).

  python -m repro_torch.examples.dispersion_analysis [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch import rvv
from repro_torch.core import planner
from repro_torch.kernels import ops


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    print("== Belady-OPT headroom over the paper's FIFO (hit rates) ==")
    b = rvv.BENCHMARKS["pathfinder"]
    built = b.build(**b.paper_params)
    res = planner.policy_headroom(built.program, capacities=(3, 4, 5, 6),
                                  device=device)
    print(f"{'cap':>4} {'fifo':>7} {'lru':>7} {'opt':>7}")
    for cap in (3, 4, 5, 6):
        print(f"{cap:>4} {res['fifo'][cap]:7.3f} {res['lru'][cap]:7.3f} "
              f"{res['opt'][cap]:7.3f}")

    print("\n== Accumulator working set vs memory traffic "
          "(granite-8b MLP) ==")
    ideal = ops.hbm_traffic_model(8192, 14336, 4096, block_m=128,
                                  block_k=512, working_set=1)["ideal"]
    print(f"{'W':>3} {'HBM GB':>8} {'acc MB':>8}   (ideal = "
          f"{ideal / 1e9:.1f} GB)")
    for w in (1, 2, 4, 8, 16):
        t = ops.hbm_traffic_model(8192, 14336, 4096, block_m=128,
                                  block_k=512, working_set=w)
        print(f"{w:>3} {t['grouped'] / 1e9:8.2f} "
              f"{t['vmem_acc_bytes'] / 1e6:8.1f}")
    print("more physical 'registers' (on-chip tiles) => less memory "
          "traffic —")
    print("the paper's Fig 4 economics at the next level of the hierarchy.")


if __name__ == "__main__":
    main()
