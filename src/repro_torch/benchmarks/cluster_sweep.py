"""Clustered vector units: cores x cVRF capacity x L1 geometry at a fixed
SRAM budget.

The paper makes one vector unit cheap; Spatz (arXiv:2309.10137) asks what
happens when you cluster many behind shared memory.  This suite answers
the question "given a fixed total SRAM budget, how do cores x
cVRF-capacity x L1 trade off?" with the cluster engine
(:mod:`repro_torch.cluster`): every (kernel, capacity, L1 geometry,
cores) point runs N lockstep dispersion cores behind a shared L2 + banked
memory channels as ONE declarative ``Session.run`` — one engine call per
L1 geometry for every ``cores`` value (K1 once, K2 per cluster point, on
the card), one plan group per (L1 geometry, cores).  The port of the
reference's ``benchmarks/cluster_sweep.py``; where it differs: the plan
groups carry no shape bucket, and the record counts engine calls and
kernel launches (``dispatches``, ``launches``) instead of XLA compiles.

Reported per point: cluster makespan cycles, the contention stall ratio,
and the three budget axes — ``sram_budget_bytes`` (total storage bits the
cluster holds: per-core cVRF + L1, plus the shared L2),
``cluster_area`` (logic + macro au) and ``aggregate_throughput`` (summed
useful writes per makespan cycle).  The headline output is the
**iso-budget Pareto front** per kernel: the (cores, capacity, L1) points
no other point beats on both storage budget and throughput — many small
cores with dispersed cVRFs vs few big-VRF cores on one curve
(``run.py --json``, ``extra.iso_budget_front``).
"""

from __future__ import annotations

from repro_torch import api
from repro_torch.benchmarks import common
from repro_torch.cluster import ClusterConfig

KERNELS = ("gemv", "dropout", "flashattention2")
CORES = (1, 2, 4, 8)
CAPS = (3, 4, 8)
L1_KBYTES = (4, 16)
# Shared memory system: 32 KB L2 (256 sets x 4 ways x 32 B), two banked
# memory channels — kept fixed so the budget axis varies only through the
# per-core choices.
CLUSTER = ClusterConfig(l2_sets=256, l2_ways=4, mem_channels=2)

_LAST_EXTRA: dict = {}


def run(names=KERNELS, cores=CORES, caps=CAPS, l1_kbytes=L1_KBYTES,
        cluster=CLUSTER, kernel_params="paper", max_events=None,
        fold=True, session=None) -> list[dict]:
    ses = session or api.default_session()
    sweep = api.Sweep(
        kernels=tuple(names), capacity=tuple(caps),
        l1_geometry=tuple(api.L1Geometry.from_kbytes(kb)
                          for kb in l1_kbytes),
        cores=tuple(cores), cluster=cluster,
        kernel_params=kernel_params, fold=fold, max_events=max_events)
    res, dt = common.timed(ses.run, sweep)
    res = (res.derive("scaled_cycles").derive("sram_budget_bytes")
              .derive("cluster_area").derive("aggregate_throughput")
              .derive("contention_stall_ratio"))
    rows = res.to_rows([
        "cycles", "scaled_cycles", "contention_stalls", "l2_hits",
        "l2_misses", "core_cycles_sum", "sram_budget_bytes",
        "cluster_area", "aggregate_throughput", "contention_stall_ratio"])
    us_each = dt * 1e6 / max(1, len(rows))
    for r in rows:
        r["name"] = r.pop("kernel")
        r["us_per_call"] = round(us_each, 1)
    fronts = {
        name: res.pareto("sram_budget_bytes", "aggregate_throughput",
                         maximize=("aggregate_throughput",), kernel=name)
        for name in sweep.kernels}
    iso_area = {
        name: res.pareto("cluster_area", "aggregate_throughput",
                         maximize=("aggregate_throughput",), kernel=name)
        for name in sweep.kernels}
    plan = res.meta["plan"]
    fe = res.data["fold_exact"]
    _LAST_EXTRA.clear()
    _LAST_EXTRA.update(
        cluster=res.meta["cluster"],
        points=res.meta["points"], dispatches=res.meta["dispatches"],
        launches=res.meta["launches"],
        plan_groups=len({(g["l1_geometry"], g["cores"]) for g in plan}),
        fold_exact_fraction=float(fe.mean()),
        iso_budget_front=fronts,
        iso_area_front=iso_area,
        rows=rows,
    )
    return rows


def main(names=KERNELS, max_events: int | None = None,
         session=None) -> list[dict]:
    rows = run(names=names, max_events=max_events, session=session)
    common.emit(rows, ["name", "us_per_call", "cores", "capacity", "l1_kb",
                       "cycles", "contention_stall_ratio",
                       "sram_budget_bytes", "aggregate_throughput"])
    front = _LAST_EXTRA["iso_budget_front"]
    print("# iso-budget Pareto front (budget_bytes -> best throughput):")
    for name, rows_f in front.items():
        pts = ", ".join(
            f"{r['sram_budget_bytes']:.0f}B:N{r['cores']}/c{r['capacity']}"
            f"/L1-{r['l1_kb']}KB" for r in rows_f)
        print(f"#   {name}: {pts}")
    return rows


def json_extra() -> dict:
    """Cluster payload for ``run.py --json``: the shared memory system,
    plan, engine-call and launch accounting, per-point rows and the
    iso-budget / iso-area Pareto fronts per kernel."""
    return dict(_LAST_EXTRA)


if __name__ == "__main__":
    main()
