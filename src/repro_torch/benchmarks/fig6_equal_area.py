"""Fig 6: equal-area comparison — Register Dispersion (cVRF of 8 x 256-bit)
vs a full 32-register VRF of reduced 64-bit vector length.

The narrow machine is the ``narrow_vrf_cycles`` model metric: with VL/4,
every vector instruction strip-mines into 4 (4x base-occupancy and 4x loop
overhead), while each 32-byte cacheline is now touched by four 8-byte
accesses (1 miss + 3 extra hits per previously-missed line); the narrow
VRF holds all 32 registers so it has no dispersion stalls.  L1 hit and
miss costs come from the sweep's machine axes (1 + ``l1_hit_cycles``, miss
adds ``mem_latency``), so equal-area results respond to machine-parameter
sweeps.  All columns are baseline-relative queries against the full-size
32 x 256-bit VRF (``baseline=dict(capacity=32)``).
"""

from __future__ import annotations

from repro_torch import api, rvv
from repro_torch.benchmarks import common

FULL = dict(capacity=32)


def run(max_events=None, fold=True, names=None, session=None) -> list[dict]:
    names = list(names or rvv.BENCHMARKS)
    ses = session or api.default_session()
    res, dt = common.timed(
        ses.run, api.Sweep(kernels=names, capacity=[8, 32],
                           fold=fold, max_events=max_events))
    us_each = dt * 1e6 / len(names)
    r = (res.derive("speedup", baseline=FULL)
            .derive("narrow_vrf_speedup")
            .derive("equal_area_advantage", baseline=FULL))
    return [dict(
        name=name, us_per_call=round(us_each, 1),
        dispersion_8x256=round(r.value("speedup", kernel=name,
                                       capacity=8), 3),
        narrow_32x64=round(r.value("narrow_vrf_speedup", kernel=name,
                                   capacity=32), 3),
        advantage=round(r.value("equal_area_advantage", kernel=name,
                                capacity=8), 2),
    ) for name in names]


def main(names=None, max_events=None, session=None):
    rows = run(names=names, max_events=max_events, session=session)
    common.emit(rows, ["name", "us_per_call", "dispersion_8x256",
                       "narrow_32x64", "advantage"])
    return rows


if __name__ == "__main__":
    main()
