"""3-objective design-space exploration: area x cycles x energy over
cVRF capacity x L1 geometry x cores, per silicon macro model.

The Pareto-frontier and cluster suites each trade TWO quantities; real
sizing decisions juggle three — silicon area, makespan cycles and
application energy — and the answer depends on what silicon the SRAM
macros are priced in.  This suite walks the whole design space (cVRF
capacity incl. the full-32 VRF, L1 size, core count behind a shared L2)
as ONE declarative ``Session.run`` through the cluster engine, then
re-prices the grid under each registered :mod:`repro_torch.silicon` macro
model and emits the **maximal 3-objective front** (``silicon_cluster_
area``, ``scaled_cycles``, ``silicon_energy``) per kernel per model via
the N-objective ``SweepResult.pareto(axes=[...])``.

Every front point carries provenance: the macro model that priced it,
the (cores, capacity, L1) geometry, its fold certificate and the plan
group (geometry x cores) that produced its counters.  The reduced-register RVV design of arXiv:2410.08396 — 16
architectural registers, full-VRF hardware, compiler register allocation
reported at near-zero performance loss — rides on each front as a
labeled **external baseline** point: its logic area is
``cpu_area(16, dispersed=False)``, its L1 macro is priced by the same
macro model, and its cycles/energy are taken from this sweep's
capacity-32 single-core point (the near-zero-loss assumption, recorded
on the point itself).

The headline finding is the **iso-area winner flip**: the ``flop``
backend's flat periphery makes small L1 macros unrealistically cheap, so
a dispersed core with a bigger L1 can undercut a full-VRF core with a
small L1 on area; under ``sram6t``'s edge-scaled periphery the ordering
reverses and the 2-objective (area, cycles) front membership changes —
``extra.iso_area_winners`` lists exactly which configurations enter or
leave each front.  ``run.py --json`` carries all of it
(``extra.fronts`` / ``external_baseline`` / ``iso_area_winners`` +
the ``macro_models`` catalog).

The port of the reference's ``benchmarks/dse.py``; where it differs: a
front point's plan-group provenance has no shape bucket, the plan groups
are counted over (geometry, cores), and the record counts engine calls
and kernel launches (``dispatches``, ``launches``) instead of XLA
compiles.

Multi-core note: the lockstep cluster runs the *same* program on every
core, so at fixed per-core work more cores buy area/energy without
cutting makespan — multi-core points are mostly dominated on this front
(they win on ``aggregate_throughput``, the cluster suite's axis, not on
latency).  They stay in the grid so the front can prove that, not assume
it.
"""

from __future__ import annotations

from repro_torch import api, silicon
from repro_torch.benchmarks import common
from repro_torch.cluster import ClusterConfig
from repro_torch.core import costmodel

KERNELS = ("gemv", "dropout", "flashattention2")
CORES = (1, 2, 4)
# 3/4/8 dispersed cVRF capacities plus the full-32 VRF reference point
# (dispersed="auto" turns the mechanism off at 32).
CAPS = (3, 4, 8, 32)
L1_KBYTES = (4, 8, 16)
MACRO_MODELS = ("flop", "sram6t", "table")
OBJECTIVES = ("silicon_cluster_area", "scaled_cycles", "silicon_energy")
# Shared memory system, fixed across the grid (as cluster_sweep): 32 KB
# L2, two banked channels.
CLUSTER = ClusterConfig(l2_sets=256, l2_ways=4, mem_channels=2)

# arXiv:2410.08396 (reduced-register RVV): halve the architectural
# vector registers, keep the full-VRF microarchitecture, recover the
# performance in the compiler's register allocator.
BASELINE_REGS = 16
BASELINE_L1_KB = 16
BASELINE_NOTE = (
    "cycles/energy from this sweep's capacity-32 single-core point: "
    "arXiv:2410.08396 reports near-zero performance loss for "
    "compiler-allocated 16-register RVV")

_LAST_EXTRA: dict = {}


def _plan_groups(plan) -> dict:
    """(kernel, l1_geometry, cores) -> plan-group provenance."""
    out = {}
    for gi, g in enumerate(plan):
        for k in g["kernels"]:
            out[(k, g["l1_geometry"], g.get("cores", 1))] = dict(
                plan_group=gi, fused=g["fused"])
    return out


def _point_info(res, models) -> dict:
    """(kernel, capacity, l1_kb, cores) -> fold certificate + per-model
    objective values, for provenance stamping and baseline lookup."""
    counters = ["fold_exact", "scaled_cycles"]
    counters += [f"area_{m}" for m in models]
    counters += [f"energy_{m}" for m in models]
    return {(r["kernel"], r["capacity"], r["l1_kb"], r["cores"]): r
            for r in res.to_rows(counters)}


def _external_baseline(res, model, name, info) -> dict:
    """The arXiv:2410.08396 point, priced under ``model``: 16-register
    full-VRF logic + the macro-priced L1, perf from the sweep's largest-
    capacity single-core point (the full-VRF reference)."""
    caps = res.axis("capacity").values
    kbs = sorted({k[2] for k in info})
    l1_kb = BASELINE_L1_KB if BASELINE_L1_KB in kbs else kbs[-1]
    cores = min(res.axis("cores").values)
    geo = api.L1Geometry.from_kbytes(l1_kb)
    m = silicon.get_macro_model(model)
    logic = costmodel.cpu_area(BASELINE_REGS, dispersed=False).total
    l1_au = float(m.area(geo.sets * geo.ways, geo.LINE_BYTES * 8))
    l2 = res.meta["cluster"]
    l2_au = float(m.area(l2["l2_sets"] * l2["l2_ways"], 32 * 8)) \
        if l2["l2_bytes"] else 0.0
    ref = info[(name, max(caps), l1_kb, cores)]
    return dict(
        external=True, source="arXiv:2410.08396",
        label=f"reduced-register RVV ({BASELINE_REGS} arch regs, "
              "full-VRF hardware)",
        kernel=name, macro_model=model, capacity=BASELINE_REGS,
        cores=cores, l1_kb=l1_kb, dispersed=False,
        silicon_cluster_area=logic + l1_au + l2_au,
        scaled_cycles=ref["scaled_cycles"],
        silicon_energy=ref[f"energy_{model}"],
        assumption=BASELINE_NOTE)


def run(names=KERNELS, cores=CORES, caps=CAPS, l1_kbytes=L1_KBYTES,
        models=MACRO_MODELS, cluster=CLUSTER, kernel_params="paper",
        max_events=None, fold=True, session=None) -> list[dict]:
    ses = session or api.default_session()
    sweep = api.Sweep(
        kernels=tuple(names), capacity=tuple(caps),
        l1_geometry=tuple(api.L1Geometry.from_kbytes(kb)
                          for kb in l1_kbytes),
        cores=tuple(cores), cluster=cluster,
        kernel_params=kernel_params, fold=fold, max_events=max_events)
    res, dt = common.timed(ses.run, sweep)
    res = res.derive("scaled_cycles")
    # Re-price the one grid under every macro model: objective columns
    # area_<model> / energy_<model> (flop == the legacy metrics,
    # bit-identically).
    for m in models:
        res = (res.derive("silicon_cluster_area", macro_model=m,
                          out=f"area_{m}")
                  .derive("silicon_energy", macro_model=m,
                          out=f"energy_{m}"))
    info = _point_info(res, models)
    groups = _plan_groups(res.meta["plan"])

    def stamp(row, model):
        """Attach provenance to one front row and surface the objective
        columns under their canonical names."""
        key = (row["kernel"], row["capacity"], row["l1_kb"], row["cores"])
        pt = info[key]
        row = dict(row, macro_model=model,
                   fold_exact=bool(pt["fold_exact"]),
                   **groups[(row["kernel"], row["l1_geometry"],
                             row["cores"])])
        row.pop(f"area_{model}", None)
        row.pop(f"energy_{model}", None)
        row["silicon_cluster_area"] = pt[f"area_{model}"]
        row["scaled_cycles"] = pt["scaled_cycles"]
        row["silicon_energy"] = pt[f"energy_{model}"]
        return row

    fronts = {m: {} for m in models}
    fronts2 = {m: {} for m in models}
    baselines = {m: {} for m in models}
    for m in models:
        for name in sweep.kernels:
            f3 = res.pareto(
                axes=[f"area_{m}", "scaled_cycles", f"energy_{m}"],
                kernel=name)
            f2 = res.pareto(f"area_{m}", "scaled_cycles", kernel=name)
            fronts[m][name] = [stamp(r, m) for r in f3]
            fronts2[m][name] = [stamp(r, m) for r in f2]
            baselines[m][name] = _external_baseline(res, m, name, info)
            fronts[m][name].append(baselines[m][name])

    # Iso-area winner flip: which (cores, capacity, L1) configurations
    # sit on the 2-objective (area, cycles) front under one silicon
    # assumption but not another.
    def config_set(front_rows):
        return {(r["cores"], r["capacity"], r["l1_kb"])
                for r in front_rows}

    winners = {}
    for name in sweep.kernels:
        per = {m: sorted(config_set(fronts2[m][name])) for m in models}
        flop, s6t = set(per["flop"]), set(per.get("sram6t", per["flop"]))
        per["changed"] = sorted(flop ^ s6t)
        winners[name] = {k: [list(c) for c in v] for k, v in per.items()}

    rows = res.to_rows(
        ["cycles", "scaled_cycles", "fold_exact"]
        + [f"area_{m}" for m in models] + [f"energy_{m}" for m in models])
    us_each = dt * 1e6 / max(1, len(rows))
    for r in rows:
        r["name"] = r.pop("kernel")
        r["us_per_call"] = round(us_each, 1)
        r["fold_exact"] = bool(r["fold_exact"])
    plan = res.meta["plan"]
    _LAST_EXTRA.clear()
    _LAST_EXTRA.update(
        objectives=list(OBJECTIVES),
        macro_models=silicon.macro_catalog(),
        cluster=res.meta["cluster"],
        points=res.meta["points"], dispatches=res.meta["dispatches"],
        launches=res.meta["launches"],
        plan_groups=len({(g["l1_geometry"], g["cores"]) for g in plan}),
        fold_exact_fraction=float(res.data["fold_exact"].mean()),
        fronts=fronts,
        fronts_2d=fronts2,
        external_baseline=baselines,
        iso_area_winners=winners,
        rows=rows,
    )
    return rows


def main(names=KERNELS, max_events: int | None = None,
         session=None) -> list[dict]:
    rows = run(names=names, max_events=max_events, session=session)
    common.emit(rows, ["name", "us_per_call", "cores", "capacity", "l1_kb",
                       "cycles", "area_flop", "area_sram6t",
                       "energy_flop", "energy_sram6t"])
    fronts = _LAST_EXTRA["fronts"]
    for m, per_kernel in fronts.items():
        print(f"# 3-objective front under macro model '{m}' "
              "(area/cycles/energy):")
        for name, rows_f in per_kernel.items():
            pts = ", ".join(
                ("EXT:" if r.get("external") else "")
                + f"N{r['cores']}/c{r['capacity']}/L1-{r['l1_kb']}KB"
                for r in rows_f)
            print(f"#   {name}: {pts}")
    print("# iso-area winner changes (flop -> sram6t, 2-obj front):")
    for name, per in _LAST_EXTRA["iso_area_winners"].items():
        ch = ", ".join(f"N{c}/c{cap}/L1-{kb}KB"
                       for c, cap, kb in per["changed"]) or "(none)"
        print(f"#   {name}: {ch}")
    return rows


def json_extra() -> dict:
    """DSE payload for ``run.py --json``: the macro-model catalog,
    per-model 3-objective fronts with provenance and the external
    arXiv:2410.08396 baseline, 2-objective projections, the iso-area
    winner diff, plan, engine-call and launch accounting and per-point
    rows."""
    return dict(_LAST_EXTRA)


if __name__ == "__main__":
    main()
