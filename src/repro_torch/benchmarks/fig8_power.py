"""Fig 8: per-application average power — full VRF vs cVRF-8 with Register
Dispersion.  Paper: ~10% average CPU+VPU power saving.

The activity-based power model runs vectorized over the whole grid at once
(the ``application_power`` model metric; ``dispersed`` is auto — any
capacity below 32 runs the mechanism), and the saving column is the
baseline-relative ``savings_pct`` query against the full VRF."""

from __future__ import annotations

import numpy as np

from repro_torch import api, rvv
from repro_torch.benchmarks import common


def run(max_events=None, fold=True, names=None, session=None) -> list[dict]:
    names = list(names or rvv.BENCHMARKS)
    ses = session or api.default_session()
    res, dt = common.timed(
        ses.run, api.Sweep(kernels=names, capacity=[8, 32],
                           fold=fold, max_events=max_events))
    us_each = dt * 1e6 / len(names)
    r = (res.derive("application_power")
            .derive("savings_pct", of="application_power",
                    baseline=dict(capacity=32), out="power_saving_pct"))
    rows = [dict(
        name=name, us_per_call=round(us_each, 1),
        power_full=round(r.value("application_power", kernel=name,
                                 capacity=32), 2),
        power_cvrf8=round(r.value("application_power", kernel=name,
                                  capacity=8), 2),
        saving_pct=round(r.value("power_saving_pct", kernel=name,
                                 capacity=8), 1),
    ) for name in names]
    avg = float(np.mean(r.array("power_saving_pct", capacity=8)))
    rows.append(dict(name="AVERAGE", us_per_call=0.0,
                     power_full="", power_cvrf8="",
                     saving_pct=round(avg, 1), paper_saving=10.0))
    return rows


def main(names=None, max_events=None, session=None):
    rows = run(names=names, max_events=max_events, session=session)
    common.emit(rows, ["name", "us_per_call", "power_full", "power_cvrf8",
                       "saving_pct", "paper_saving"])
    return rows


if __name__ == "__main__":
    main()
