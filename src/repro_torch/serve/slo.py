"""SLO accounting over a finished serving run.

:func:`summarize` folds a completed ``ServeEngine.serve`` run (the request
list plus the engine's telemetry) into one :class:`SLOReport` row — the
unit the SLO benchmark sweeps over and the Pareto front is built from:

  * **latency** — per-token decode latency percentiles (p50/p99 of
    inter-token gaps, virtual ticks) and time-to-first-token;
  * **throughput** — tokens per tick overall, and separately during
    *degraded* windows (fault active / slot frozen / pool shrunk), so the
    "graceful" in graceful degradation is a number, not an adjective;
  * **SLO** — deadline-miss rate over admission attempts, plus terminal
    counts (done / failed / rejected / retries / preemptions);
  * **footprint** — hot-pool fast-memory bytes (dispersed mode) or the
    full resident cache size, the x-axis of the paper's economics.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serve.engine import DONE, FAILED, REJECTED

__all__ = ["SLOReport", "summarize"]


@dataclasses.dataclass(frozen=True)
class SLOReport:
    n_requests: int
    n_done: int
    n_failed: int
    n_rejected: int
    n_retries: int
    n_preemptions: int
    deadline_misses: int
    deadline_miss_rate: float
    tokens_out: int
    elapsed_ticks: float
    tokens_per_tick: float
    degraded_ticks: float
    degraded_tokens: int
    degraded_tokens_per_tick: float
    p50_decode_ticks: float
    p99_decode_ticks: float
    mean_ttft_ticks: float
    hot_bytes: int
    pool_hit_rate: float
    pool_spills: int
    pool_shrinks: int

    def to_row(self) -> dict:
        return dataclasses.asdict(self)


def _percentile(values: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(values), q)) if values else 0.0


def summarize(engine, requests) -> SLOReport:
    """Fold one finished run into an :class:`SLOReport`."""
    gaps: list[float] = []          # inter-token decode latencies
    ttfts: list[float] = []         # admission -> first token
    tokens_out = 0
    for r in requests:
        tokens_out += len(r.out)
        if r.first_token_t is not None and r.admit_t is not None:
            ttfts.append(r.first_token_t - r.admit_t)
        ts = r.token_times
        gaps.extend(b - a for a, b in zip(ts, ts[1:]))

    log = engine.step_log
    elapsed = log[-1]["t"] if log else 0.0
    degraded_ticks = sum(row["dur"] for row in log if row["degraded"])
    degraded_tokens = sum(row["emitted"] for row in log if row["degraded"])

    n_done = sum(r.status == DONE for r in requests)
    n_failed = sum(r.status == FAILED for r in requests)
    n_rejected = sum(r.status == REJECTED for r in requests)
    # every deadline miss ends one admission attempt, as does each
    # terminal done/failed — the denominator of the miss rate
    attempts = n_done + n_failed + engine.deadline_misses
    stats = engine.kv_stats()
    if stats:
        hot_bytes = stats["hot_bytes"]
    else:
        hot_bytes = sum(v.numel() * v.element_size()
                        for v in engine.cache.values())
    return SLOReport(
        n_requests=len(requests),
        n_done=n_done,
        n_failed=n_failed,
        n_rejected=n_rejected,
        n_retries=sum(r.retries for r in requests),
        n_preemptions=sum(r.preemptions for r in requests),
        deadline_misses=engine.deadline_misses,
        deadline_miss_rate=engine.deadline_misses / max(attempts, 1),
        tokens_out=tokens_out,
        elapsed_ticks=float(elapsed),
        tokens_per_tick=tokens_out / max(elapsed, 1e-9),
        degraded_ticks=float(degraded_ticks),
        degraded_tokens=int(degraded_tokens),
        degraded_tokens_per_tick=degraded_tokens / max(degraded_ticks, 1e-9)
        if degraded_ticks else 0.0,
        p50_decode_ticks=_percentile(gaps, 50),
        p99_decode_ticks=_percentile(gaps, 99),
        mean_ttft_ticks=float(np.mean(ttfts)) if ttfts else 0.0,
        hot_bytes=int(hot_bytes),
        pool_hit_rate=float(stats.get("hit_rate", 1.0)) if stats else 1.0,
        pool_spills=int(stats.get("spills", 0)) if stats else 0,
        pool_shrinks=int(stats.get("shrinks", 0)) if stats else 0,
    )
