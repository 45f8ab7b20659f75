"""Ablation (beyond-paper): is the paper's "8 registers suffice" conclusion
robust to the memory system?  Sweeps main-memory latency (Table 1 gives a
1-5 cycle range; we extend to 10) and L1D capacity, and reports the cVRF-8
performance (normalised to the full VRF under the SAME machine).

If dispersion relied on a fast memory system, slow memories would break it;
the result shows the conclusion is latency-robust because spill/fill
traffic is tiny and L1-resident.

Sweep shape: ONE declarative ``repro_torch.api.Sweep`` covers the whole
study — ``l1_geometry`` is a first-class axis, so the static L1
capacities are planned by the Session (one engine call per geometry),
while the memory latencies ride the machine axis inside each call (M = 4
machine points in one K1 call).  The per-point affine cross-check
(``costmodel.check_machine_affine``) certifies the machine grid against
the analytic machine model on every run.
"""

from __future__ import annotations

from repro_torch import api
from repro_torch.benchmarks import common
from repro_torch.core import costmodel, simulator

APPS = ("pathfinder", "gemv", "dropout", "flashattention2")
MEM_LATENCIES = (1, 3, 5, 10)
L1_KBYTES = (4, 16)
GEOMETRIES = tuple(api.L1Geometry.from_kbytes(kb) for kb in L1_KBYTES)


def machine_grid(l1_kb: int) -> simulator.MachineSweep:
    """The latency axis for one (static) L1 capacity."""
    return simulator.MachineSweep.make(
        MEM_LATENCIES, l1_sets=l1_kb * 1024 // 32 // 2)


def run(max_events=None, fold=True, check_affine=True,
        session=None) -> list[dict]:
    ses = session or api.default_session()
    res, dt = common.timed(
        ses.run, api.Sweep(kernels=APPS, capacity=[8, 32],
                           mem_latency=MEM_LATENCIES,
                           l1_geometry=GEOMETRIES,
                           fold=fold, max_events=max_events))
    us_each = dt * 1e6 / (len(APPS) * len(MEM_LATENCIES) * len(L1_KBYTES))
    if check_affine:
        for l1_kb in L1_KBYTES:
            costmodel.check_machine_affine(
                res.to_grid(l1_geometry=api.L1Geometry.from_kbytes(l1_kb)),
                machine_grid(l1_kb))
    rows = []
    for l1_kb in L1_KBYTES:
        geo = api.L1Geometry.from_kbytes(l1_kb)
        for mem_lat in MEM_LATENCIES:
            for name in APPS:
                pt = dict(kernel=name, mem_latency=mem_lat, l1_geometry=geo)
                rows.append(dict(
                    name=f"{name}_mem{mem_lat}_l1_{l1_kb}k",
                    kernel=name, mem_latency=mem_lat, l1_kb=l1_kb,
                    us_per_call=round(us_each, 1),
                    cycles=res.value("cycles", capacity=8, **pt),
                    perf_cvrf8=round(res.value("cycles", capacity=32, **pt)
                                     / res.value("cycles", capacity=8, **pt),
                                     4),
                    hit_rate=round(res.value("hit_rate", capacity=8, **pt),
                                   4),
                ))
    return rows


def main(session=None):
    rows = run(session=session)
    common.emit(rows, ["name", "us_per_call", "perf_cvrf8", "hit_rate"])
    return rows


if __name__ == "__main__":
    main()
