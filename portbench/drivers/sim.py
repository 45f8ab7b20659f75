"""Design-space sweeps through the port's front door (``kind: "sim"``).

Set-up opens one ``repro_torch.api.Session``, as an architect's tool
keeps one open, and runs one query per L1 geometry of the configuration:
that builds and prepares every program for every geometry, builds K1 and
warms each shape the window will use.  The window is a closed loop of
one client: each query is one ``Session.run`` of a ``Sweep`` over every
program and the whole design space at one geometry, the geometries drawn
from the seed (:func:`portbench.traffic.sweep_queries`).

``correct``: every query's counters are kept.  After the window, for
each geometry one answered query is drawn from the seed, and for each
program one (capacity, policy, alloc_no_fetch) point; the plain walk
(:mod:`portbench.reference.rvv_walk`) gives that point's twelve counters
at every memory latency from its own unfolded copy of the program, and
each must equal the query's.  Every other query of the geometry must
equal the drawn one bit for bit, so every answer of the window is held.
"""

from __future__ import annotations

import gc
import hashlib
import multiprocessing
import os
import sys
import time

import numpy as np

from portbench import harness, yardstick
from portbench import traffic as gen
from portbench.reference import rvv_walk

COUNTERS = rvv_walk.COUNTERS


def _axes(config: dict) -> dict:
    space = config["design_space"]
    return dict(capacity=tuple(space["capacity"]),
                policy=tuple(space["policy"]),
                alloc_no_fetch=tuple(bool(a) for a in space["alloc_no_fetch"]),
                mem_latency=tuple(space["mem_latency"]),
                l1_hit_cycles=(config["machine"]["l1_hit_cycles"],),
                uop_hit_cycles=(config["machine"]["uop_hit_cycles"],))


def instructions(config: dict) -> dict:
    """Unfolded rows of each program: the yardstick's counts at paper
    size, else (smaller builds, in tests) the frozen copy's."""
    if config["kernel_params"] == "paper":
        return {p: yardstick.INSTRUCTIONS[p] for p in config["programs"]}
    from portbench.reference import rvvtrace
    out = {}
    for p in config["programs"]:
        b = rvvtrace.get_benchmark(p)
        out[p] = b.build(**_params(b, config)).program.num_instructions
    return out


def _params(bench, config):
    kp = config["kernel_params"]
    return dict(bench.paper_params if kp == "paper" else
                bench.reduced_params if kp == "reduced" else kp)


def _digest(res) -> str:
    h = hashlib.sha256()
    for k in COUNTERS:
        h.update(np.ascontiguousarray(res[k]).tobytes())
    return h.hexdigest()


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             t0: float, device: str = "cuda", workers: int | None = None):
    import torch
    from repro_torch import api

    config, mix = spec["config"], spec["traffic"]
    axes = _axes(config)
    geos = [api.L1Geometry.from_kbytes(kb, config["l1_ways"])
            for kb in config["l1_kb"]]
    sweeps = [api.Sweep(kernels=tuple(config["programs"]), l1_geometry=(g,),
                        kernel_params=config["kernel_params"],
                        max_events=config.get("max_events"), **axes)
              for g in geos]
    session = api.Session(device=device)
    for sw in sweeps:                     # set-up: build, prepare, warm
        session.run(sw)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    rows = instructions(config)
    per_query_rows = sum(rows.values())
    points_per_program = int(np.prod([len(v) for v in axes.values()]))
    order = gen.sweep_queries(mix, geos, seed, 1 << 20)
    queries, kept = [], []
    prof = harness.profiler() if trace else None
    if prof is not None:
        prof.start()
    wall0 = time.time_ns()          # the profiler's events carry this clock
    start = time.perf_counter()
    i = 0
    while True:
        g = order[i]
        e0 = session.engine_seconds()
        q0 = time.perf_counter()
        with harness.span("portbench.sim.query", prof):
            res = session.run(sweeps[g])
        q1 = time.perf_counter()
        queries.append(dict(geometry=g, latency_s=q1 - q0,
                            engine_s=session.engine_seconds() - e0))
        kept.append({k: np.asarray(res[k]) for k in COUNTERS + ("fold_exact",)})
        i += 1
        if q1 - start >= seconds:
            break
    window_s = q1 - start
    traced = None
    if prof is not None:
        prof.stop()
        traced = harness.Trace(prof, wall0, window_s)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    del session, res
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    n = len(queries)
    e2e = {"sim_instr_rate": n * points_per_program * per_query_rows
           / window_s / 1e9, "setup_s": setup_s}
    r0 = time.perf_counter()
    checks, uncertified = _check(config, axes, geos, queries, kept, seed,
                                 workers)
    print(f"sim: {n} queries in {window_s:.3f} s, set-up {setup_s:.3f} s, "
          f"reference {time.perf_counter() - r0:.3f} s, uncertified "
          f"points in the checked queries {uncertified}", file=sys.stderr)
    ctx = dict(queries=queries, window_s=window_s, trace=traced,
               k1_bound_bytes=yardstick.k1_bytes_bound(
                   per_query_rows,
                   points_per_program * len(config["programs"])))
    return dict(e2e=e2e, ctx=ctx, checks=checks, attempted=n, failed=0,
                peak_bytes=peak, trace=traced)


def _check(config, axes, geos, queries, kept, seed, workers):
    """The compared numbers: counters that differ from the plain walk,
    and queries that differ from the checked query of their geometry."""
    rng = np.random.default_rng([int(seed) % 2**63, 3])
    cfgs = [(c, p, a) for c in axes["capacity"] for p in axes["policy"]
            for a in axes["alloc_no_fetch"]]
    tasks, picked = [], {}
    for g in range(len(geos)):
        ids = [i for i, q in enumerate(queries) if q["geometry"] == g]
        if not ids:
            continue
        picked[g] = ids[int(rng.integers(len(ids)))]
        for pi, prog in enumerate(config["programs"]):
            ci = int(rng.integers(len(cfgs)))
            tasks.append((g, pi, ci, dict(
                program=prog, kernel_params=config["kernel_params"],
                point=cfgs[ci], l1_sets=geos[g].sets, l1_ways=geos[g].ways,
                mem_latency=axes["mem_latency"],
                l1_hit_cycles=axes["l1_hit_cycles"][0],
                uop_hit_cycles=axes["uop_hit_cycles"][0])))
    # The largest programs first, so the longest walks start at once.
    rows = instructions(config)
    tasks.sort(key=lambda t: -rows[t[3]["program"]])
    refs = _walk_all([t[3] for t in tasks], workers)
    shape = (len(config["programs"]), len(axes["capacity"]),
             len(axes["policy"]), len(axes["alloc_no_fetch"]))
    mismatched = compared = 0
    for (g, pi, ci, _), ref in zip(tasks, refs):
        c, p, a = np.unravel_index(ci, shape[1:])
        got = kept[picked[g]]
        for k in COUNTERS:
            vals = got[k][pi, c, p, a, 0, :, 0, 0].tolist()
            compared += len(vals)
            mismatched += sum(int(x) != int(y)
                              for x, y in zip(vals, ref[k]))
    digests = {g: _digest(kept[i]) for g, i in picked.items()}
    unlike = sum(_digest(kept[i]) != digests[q["geometry"]]
                 for i, q in enumerate(queries))
    uncertified = int(sum((~kept[i]["fold_exact"]).sum()
                          for i in picked.values()))
    checks = [
        dict(name="counters_unequal", value=mismatched, limit=0,
             ok=mismatched == 0 and compared > 0),
        dict(name="counters_compared", value=compared,
             limit=">0", ok=compared > 0),
        dict(name="queries_unlike_checked", value=unlike, limit=0,
             ok=unlike == 0),
    ]
    return checks, uncertified


def _walk_all(tasks: list, workers: int | None) -> list:
    workers = min(len(tasks), workers or os.cpu_count() or 1)
    if workers <= 1:
        return [rvv_walk.walk_task(t) for t in tasks]
    pool = multiprocessing.get_context("spawn").Pool(workers)
    try:
        out = pool.map(rvv_walk.walk_task, tasks, chunksize=1)
    finally:
        pool.close()
        pool.join()
    return out
