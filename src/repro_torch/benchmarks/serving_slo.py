"""Serving SLO study: the paper's compact-pool bet measured while the
system is failing.

Sweeps hot-pool size x eviction policy x traffic mix x fault profile over
the dispersed-KV serving engine (`repro_torch.serve`): every grid point
runs one seeded, replayable scenario on the virtual clock — Poisson or
bursty MMPP arrivals, per-request deadlines, and (optionally) injected
latency spikes, a transient slot failure and a live hot-pool shrink.  The
per-point :class:`repro_torch.serve.slo.SLOReport` rows ride
:class:`repro_torch.api.SweepResult` (``from_table``), so the Pareto front
of fast-memory footprint vs decode latency comes from the same
``pareto()`` the cVRF studies use — and the derived SLO metrics
(``slo_attainment``, ``goodput``, ``degraded_throughput_ratio``) come from
the ``repro_torch.metrics`` registry.

Port of ``benchmarks/serving_slo.py``.  Where it differs: the reduced
model takes the port's own seeded init (a request ends on its length and
decoding is greedy, so no row depends on the weights), and every point
calls ``Model.decode_step`` eagerly on ``device`` (no compiled decode).

``--max-events N`` is the budget knob: it caps engine steps per point and
scales the request count; at N <= 200 the grid also trims to the smoke
roster (2 hot-pool sizes x FIFO x steady x {none, chaos}).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch import api
from repro_torch.benchmarks import common
from repro_torch.configs import registry
from repro_torch.core import policies
from repro_torch.models import Model
from repro_torch.serve import (FAULT_PROFILES, TRAFFIC_MIXES, FaultInjector,
                               ServeEngine, generate, slo)

ARCH = "phi3-mini-3.8b"      # dense GQA: the paged-KV layout
SLOTS = 2
MAX_LEN = 48
PAGE_SIZE = 8
DEADLINE = 150.0             # ticks per admission attempt
SEED = 0

HOT_PAGES = (6, 10, 16)
POLICIES = (policies.FIFO, policies.LRU)
MIXES = ("steady", "bursty")
FAULTS = ("none", "chaos")

SMOKE_HOT_PAGES = (6, 16)

_LAST_EXTRA: dict = {}


def _scenario(mix: str, n_requests: int, vocab: int):
    cfg = dataclasses.replace(
        TRAFFIC_MIXES[mix], n_requests=n_requests, max_len=MAX_LEN,
        vocab=vocab, deadline=DEADLINE)
    return generate(cfg, seed=SEED)


def run(max_events: int | None = None, device="cuda"
        ) -> tuple[api.SweepResult, list[dict]]:
    """Execute the sweep; returns (labeled grid, flat rows)."""
    smoke = max_events is not None and max_events <= 200
    hot_sizes = SMOKE_HOT_PAGES if smoke else HOT_PAGES
    pols = (policies.FIFO,) if smoke else POLICIES
    mixes = ("steady",) if smoke else MIXES
    n_requests = max(3, max_events // 40) if max_events else 12
    max_steps = max_events if max_events else 50_000

    cfg = registry.get(ARCH).reduced()
    model = Model(cfg, device=device)
    model.init(torch.Generator(device=model.device).manual_seed(SEED))

    scenarios = {m: _scenario(m, n_requests, cfg.vocab_size) for m in mixes}
    rows = []
    for mix in mixes:
        scen = scenarios[mix]
        horizon = scen.horizon + 20 * n_requests
        for hot in hot_sizes:
            for pol in pols:
                for fault in FAULTS:
                    t0 = time.time()
                    eng = ServeEngine(
                        cfg, model, slots=SLOTS, max_len=MAX_LEN,
                        kv_mode="dispersed", page_size=PAGE_SIZE,
                        hot_pages=hot, pool_policy=pol, seed=SEED,
                        device=device)
                    profile = FAULT_PROFILES[fault](
                        horizon, SLOTS, hot, seed=SEED)
                    reqs = eng.serve(scen, chaos=FaultInjector(profile),
                                     max_steps=max_steps)
                    rep = slo.summarize(eng, reqs)
                    rows.append(dict(
                        hot_pages=hot, policy=pol, traffic=mix,
                        fault=fault,
                        us_per_call=round((time.time() - t0) * 1e6, 1),
                        **rep.to_row()))
    axes = dict(hot_pages=hot_sizes, policy=pols, traffic=mixes,
                fault=FAULTS)
    result = api.SweepResult.from_table(axes, rows)
    result = result.derive("slo_attainment").derive("goodput") \
                   .derive("degraded_throughput_ratio")
    return result, rows


def main(max_events: int | None = None, device="cuda") -> list[dict]:
    global _LAST_EXTRA
    result, rows = run(max_events=max_events, device=device)
    # footprint vs latency: the serving restatement of the paper's
    # capacity-vs-cycles front, under faults and fault-free
    fronts = {}
    for fault in FAULTS:
        fronts[fault] = dict(
            p50=result.pareto("hot_bytes", "p50_decode_ticks", fault=fault),
            p99=result.pareto("hot_bytes", "p99_decode_ticks", fault=fault),
        )
    _LAST_EXTRA = dict(
        pareto=fronts,
        axes={k: list(v) for k, v in
              dict(hot_pages=result.axis("hot_pages").values,
                   policy=[policies.POLICY_NAMES[p]
                           for p in result.axis("policy").values],
                   traffic=result.axis("traffic").values,
                   fault=result.axis("fault").values).items()},
    )
    out_rows = []
    for r in rows:
        out_rows.append(dict(
            name=(f"hot{r['hot_pages']}_"
                  f"{policies.POLICY_NAMES[r['policy']]}_"
                  f"{r['traffic']}_{r['fault']}"),
            us_per_call=r["us_per_call"],
            tokens_per_tick=round(r["tokens_per_tick"], 4),
            p50=round(r["p50_decode_ticks"], 3),
            p99=round(r["p99_decode_ticks"], 3),
            miss_rate=round(r["deadline_miss_rate"], 4),
            degraded_tps=round(r["degraded_tokens_per_tick"], 4),
            hot_kb=r["hot_bytes"] // 1024,
            done=r["n_done"], failed=r["n_failed"],
            rejected=r["n_rejected"], preempts=r["n_preemptions"]))
    common.emit(out_rows, ["name", "us_per_call", "tokens_per_tick", "p50",
                           "p99", "miss_rate", "degraded_tps", "hot_kb",
                           "done", "failed", "rejected", "preempts"])
    return out_rows


def json_extra() -> dict:
    """Per-suite JSON payload for ``run.py --json`` (schema >= 4): the
    footprint-vs-latency Pareto fronts and the sweep axes."""
    return _LAST_EXTRA


if __name__ == "__main__":
    main()
