"""Fig 4: (a) performance of cVRF sizes 3..16 normalised to the full VRF and
(b) cVRF hit rates, for every benchmark application (FIFO, as the paper).

One declarative sweep: all applications x all capacities through
``repro_torch.api`` — the Session plans one fused engine call per L1
geometry (folded traces, exact for steady-state kernels).  The normalised
performance column is the ``speedup`` metric against the full-VRF
baseline.
"""

from __future__ import annotations

from repro_torch import api, rvv
from repro_torch.benchmarks import common

CAPS = list(range(3, 17))


def run(names=None, max_events=None, fold=True, session=None) -> list[dict]:
    names = list(names or rvv.BENCHMARKS)
    ses = session or api.default_session()
    res, dt = common.timed(
        ses.run, api.Sweep(kernels=names, capacity=CAPS + [32],
                           fold=fold, max_events=max_events))
    us_each = dt * 1e6 / len(names)
    r = res.derive("speedup", baseline=dict(capacity=32))
    rows = []
    for name in names:
        for cap in CAPS:
            pt = dict(kernel=name, capacity=cap)
            rows.append(dict(
                name=name, us_per_call=round(us_each, 1), capacity=cap,
                norm_perf=round(r.value("speedup", **pt), 4),
                hit_rate=round(r.value("hit_rate", **pt), 4),
                spills=r.value("spills", **pt),
                fills=r.value("fills", **pt),
                fold_exact=r.value("fold_exact", **pt),
            ))
    return rows


def main(names=None, max_events=None, session=None):
    rows = run(names=names, max_events=max_events, session=session)
    common.emit(rows, ["name", "us_per_call", "capacity", "norm_perf",
                       "hit_rate", "spills", "fills", "fold_exact"])
    return rows


if __name__ == "__main__":
    main()
