"""Beyond-paper: the paper's central trade-off as one query — silicon area
vs execution cycles, per kernel, over cVRF capacity x L1 geometry.

Register Dispersion is an area-performance argument: §4.4.1 spends area
savings (3.5x smaller VRF) against Fig 4's cycle overheads.  This study
makes that the object itself: ONE declarative ``Session.run`` over the
``capacity`` and ``l1_geometry`` axes, the ``area_with_l1`` model metric
(CPU+VPU logic plus the L1 SRAM macro, so shrinking the cache is a real
option on the area axis), and ``SweepResult.pareto`` extracting the
maximal (non-dominated) front per kernel.  Design-space studies like
Spatz (arXiv:2309.10137) or reduced-register RVV (arXiv:2410.08396) are
the same query with different axis values.
"""

from __future__ import annotations

from repro_torch import api, rvv
from repro_torch.benchmarks import common

CAPS = (3, 4, 5, 6, 8, 10, 12, 16, 32)
L1_KBYTES = (4, 16)
GEOMETRIES = tuple(api.L1Geometry.from_kbytes(kb) for kb in L1_KBYTES)


def run(max_events=None, fold=True, names=None, session=None,
        caps=CAPS, geometries=GEOMETRIES) -> list[dict]:
    names = list(names or rvv.BENCHMARKS)
    ses = session or api.default_session()
    res, dt = common.timed(
        ses.run, api.Sweep(kernels=names, capacity=list(caps),
                           l1_geometry=list(geometries),
                           fold=fold, max_events=max_events))
    us_each = dt * 1e6 / len(names)
    r = res.derive("area_with_l1").derive("scaled_cycles")
    rows = []
    for name in names:
        front = r.pareto(x="area_with_l1", y="scaled_cycles", kernel=name)
        n_points = len(caps) * len(geometries)
        for f in front:
            rows.append(dict(
                name=name, us_per_call=round(us_each, 1),
                capacity=f["capacity"], l1_kb=f["l1_kb"],
                area_with_l1=round(f["area_with_l1"], 0),
                cycles=int(f["scaled_cycles"]),
                front_size=len(front), grid_points=n_points,
            ))
    return rows


def main(names=None, max_events=None, session=None):
    rows = run(names=names, max_events=max_events, session=session)
    common.emit(rows, ["name", "us_per_call", "capacity", "l1_kb",
                       "area_with_l1", "cycles", "front_size",
                       "grid_points"])
    return rows


if __name__ == "__main__":
    main()
