"""Table 3: VPU (full VRF) speedup over scalar execution, active vector
registers, and VRF utilisation — side by side with the paper's numbers.

All applications share one declarative full-VRF sweep through
``repro_torch.api`` (folded traces: cycle totals are extrapolated exactly for steady-state
kernels instead of the old scaled prefix).  The speedup column is the
``scalar_speedup`` metric — the analytic ``ScalarCost`` baseline per
kernel over truncation-corrected ``scaled_cycles`` — so the table carries
no hand-rolled counter arithmetic.
"""

from __future__ import annotations

from repro_torch import api, rvv
from repro_torch.benchmarks import common
from repro_torch.core import isa


def run(max_events=None, fold=True, names=None, session=None) -> list[dict]:
    names = list(names or rvv.BENCHMARKS)
    ses = session or api.default_session()
    res, dt = common.timed(
        ses.run, api.Sweep(kernels=names, capacity=[isa.NUM_ARCH_VREGS],
                           fold=fold, max_events=max_events))
    us_each = dt * 1e6 / len(names)
    r = res.derive("scalar_speedup")    # pulls scalar_cycles+scaled_cycles
    rows = []
    for name in names:
        # Beyond-paper kernels (conv2d_batched, mha) have no Table 3 row.
        paper = rvv.PAPER_TABLE3.get(name, dict(speedup="", active_regs="",
                                                util=""))
        active = len(ses.built(name).program.active_vregs())
        rows.append(dict(
            name=name, us_per_call=round(us_each, 1),
            speedup=round(r.value("scalar_speedup", kernel=name), 2),
            paper_speedup=paper["speedup"],
            active_regs=active, paper_active=paper["active_regs"],
            vrf_util=round(active / isa.NUM_ARCH_VREGS, 2),
            paper_util=paper["util"],
            vec_cycles=int(r.value("scaled_cycles", kernel=name)),
            scalar_cycles=int(r.value("scalar_cycles", kernel=name)),
        ))
    return rows


def main(names=None, max_events=None, session=None):
    rows = run(names=names, max_events=max_events, session=session)
    common.emit(rows, ["name", "us_per_call", "speedup", "paper_speedup",
                       "active_regs", "paper_active", "vrf_util",
                       "paper_util", "vec_cycles", "scalar_cycles"])
    return rows


if __name__ == "__main__":
    main()
