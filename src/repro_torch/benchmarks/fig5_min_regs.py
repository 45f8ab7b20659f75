"""Fig 5: minimum cVRF capacity for a >95% hit rate, per application.
Paper's claim: 8 registers suffice for (almost) all; FlashAttention-2 needs
only 3 despite touching all 32 architectural registers."""

from __future__ import annotations

from repro_torch import api, rvv
from repro_torch.benchmarks import common

PAPER_MIN = {  # read off the paper's Fig 5
    "pathfinder": 6, "jacobi2d": 7, "somier": 8, "gemv": 5, "dropout": 3,
    "conv2d_7x7": 8, "densenet121_l105": 3, "resnet50_l10": 3,
    "flashattention2": 3,
}

CAPS = list(range(3, 17))


def run(max_events=None, fold=True, target=0.95, names=None,
        session=None) -> list[dict]:
    names = list(names or rvv.BENCHMARKS)
    ses = session or api.default_session()
    res, dt = common.timed(
        ses.run, api.Sweep(kernels=names, capacity=CAPS + [32],
                           fold=fold, max_events=max_events))
    us_each = dt * 1e6 / len(names)
    rows = []
    for name in names:
        hit = {c: res.value("hit_rate", kernel=name, capacity=c)
               for c in CAPS}
        ok = [c for c in CAPS if hit[c] > target]
        min_regs = min(ok) if ok else max(CAPS) + 1
        rows.append(dict(
            name=name, us_per_call=round(us_each, 1),
            min_regs=min_regs, paper_min=PAPER_MIN.get(name, ""),
            active_regs=len(ses.built(name).program.active_vregs()),
            hit_at_min=round(hit.get(min_regs, 0.0), 4),
        ))
    return rows


def main(names=None, max_events=None, session=None):
    rows = run(names=names, max_events=max_events, session=session)
    common.emit(rows, ["name", "us_per_call", "min_regs", "paper_min",
                       "active_regs", "hit_at_min"])
    return rows


if __name__ == "__main__":
    main()
