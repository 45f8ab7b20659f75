"""Beyond-paper serving analogue: dispersed KV page pool hit rates under a
decode access pattern, swept over hot-pool sizes — the Fig 4(b) curve
reproduced at KV-page granularity with the SAME policy code.

Port of ``benchmarks/kv_dispersion.py``: the pool's pages live on
``device`` (the card by default), its controller on the host.

    python -m repro_torch.benchmarks.run kv_dispersion [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.benchmarks import common
from repro_torch.core import policies
from repro_torch.serve import DispersedKVPool, PagePoolConfig


def _decode_trace(n_pages=64, steps=600, seed=0):
    """Paged-attention access pattern: every step touches the current tail
    page plus a few random history pages (sparse attention reads), with
    sinks (page 0) touched every step."""
    g = np.random.default_rng(seed)
    seq = []
    for t in range(steps):
        tail = min(t // 8, n_pages - 1)
        seq.append((0, False))                       # pinned sink
        seq.append((tail, True))                     # append new KV
        for p in g.integers(0, max(tail, 1), 3):
            seq.append((int(p), False))              # history reads
    return seq


WARMUP_STEPS = 40     # fills during cold start are not steady-state misses


def run(steps: int = 600, device="cuda") -> list[dict]:
    """``steps`` is the decode-trace length — the harness budget knob (the
    pool does one host->device dispatch per access, so wall time is linear
    in it); ``run.py --max-events`` forwards here.  The first
    ``WARMUP_STEPS`` prime the pool, then ``reset_stats()`` starts the
    measured steady-state window."""
    rows = []
    warm = min(WARMUP_STEPS, steps // 4)
    trace = _decode_trace(steps=steps)
    split = warm * 5      # the trace makes 5 pool accesses per step
    for hot in (4, 8, 16, 32):
        for pol, pname in ((policies.FIFO, "fifo"), (policies.LRU, "lru")):
            t0 = time.time()
            pool = DispersedKVPool(PagePoolConfig(
                num_logical_pages=64, num_hot_pages=hot,
                page_shape=(16, 2, 8), policy=pol), device=device)
            for i, (page, write) in enumerate(trace):
                if i == split:
                    pool.reset_stats()
                if write:
                    pool.write(page, pool.read(page) + 1)
                else:
                    pool.read(page)
            st = pool.stats()
            rows.append(dict(
                name=f"hot{hot}_{pname}",
                us_per_call=round((time.time() - t0) * 1e6, 1),
                hit_rate=round(st["hit_rate"], 4), spills=st["spills"],
                hot_kb=st["hot_bytes"] // 1024))
    return rows


def main(max_events: int | None = None, device="cuda"):
    rows = run(steps=max_events if max_events else 600, device=device)
    common.emit(rows, ["name", "us_per_call", "hit_rate", "spills",
                       "hot_kb"])
    return rows


if __name__ == "__main__":
    main()
