"""Beyond-paper: replacement-policy headroom — FIFO (paper) vs LRU / LFU /
Belady-OPT hit rates, plus the allocate-no-fetch write optimisation.

OPT upper-bounds any realizable policy; the FIFO->OPT gap quantifies what
the paper's simplicity choice leaves on the table.

The whole study — applications x capacities x policies x no-fetch — is one
declarative ``repro_torch.api.Sweep`` on folded traces, using the zipped
``config_points`` axis (the per-capacity FIFO+no-fetch extra column is not
a cartesian product).  The headroom and no-fetch columns are
baseline-relative metric queries: ``baseline=dict(policy="fifo",
alloc_no_fetch=False)`` aligns every zipped config point against the FIFO
point of the *same capacity*, so ``delta``/``speedup`` broadcast per
capacity without any per-point arithmetic.
"""

from __future__ import annotations

from repro_torch import api
from repro_torch.benchmarks import common
from repro_torch.core import policies

CAPS = (4, 6, 8)
APPS = ("pathfinder", "jacobi2d", "gemv", "somier", "conv2d_7x7",
        "flashattention2")
POLS = (policies.FIFO, policies.LRU, policies.LFU, policies.OPT)

FIFO_BASE = dict(policy="fifo", alloc_no_fetch=False)


def config_points() -> list[api.ConfigPoint]:
    """Every (cap, policy) plus FIFO+allocate-no-fetch per capacity."""
    pts = []
    for cap in CAPS:
        pts.extend(api.ConfigPoint(cap, pol) for pol in POLS)
        pts.append(api.ConfigPoint(cap, policies.FIFO, True))
    return pts


def run(max_events=None, fold=True, session=None) -> list[dict]:
    ses = session or api.default_session()
    res, dt = common.timed(
        ses.run, api.Sweep(kernels=APPS, config_points=config_points(),
                           fold=fold, max_events=max_events))
    us_each = dt * 1e6 / len(APPS)
    r = (res.derive("delta", of="hit_rate", baseline=FIFO_BASE,
                    out="hit_rate_gain")
            .derive("speedup", baseline=FIFO_BASE))
    rows = []
    for name in APPS:
        for cap in CAPS:
            row = dict(name=name, capacity=cap,
                       us_per_call=round(us_each, 1))
            for pol in POLS:
                row[policies.POLICY_NAMES[pol]] = round(
                    r.value("hit_rate", kernel=name, capacity=cap,
                            policy=pol, alloc_no_fetch=False), 4)
            row["opt_headroom"] = round(
                r.value("hit_rate_gain", kernel=name, capacity=cap,
                        policy=policies.OPT, alloc_no_fetch=False), 4)
            row["fifo_cycles"] = r.value(
                "cycles", kernel=name, capacity=cap, policy=policies.FIFO,
                alloc_no_fetch=False)
            row["fifo_no_fetch_cycles"] = r.value(
                "cycles", kernel=name, capacity=cap, alloc_no_fetch=True)
            row["no_fetch_speedup"] = round(
                r.value("speedup", kernel=name, capacity=cap,
                        alloc_no_fetch=True), 4)
            rows.append(row)
    return rows


def main(max_events=None, session=None):
    rows = run(max_events=max_events, session=session)
    common.emit(rows, ["name", "us_per_call", "capacity", "fifo", "lru",
                       "lfu", "opt", "opt_headroom", "fifo_cycles",
                       "fifo_no_fetch_cycles", "no_fetch_speedup"])
    return rows


if __name__ == "__main__":
    main()
