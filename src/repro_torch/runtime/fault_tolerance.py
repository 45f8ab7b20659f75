"""Fault-tolerance runtime: heartbeats, straggler detection, restart policy.

On a real multi-pod deployment every host runs a :class:`Heartbeat`
reporting step progress; the coordinator applies :class:`StragglerPolicy`
(flag hosts whose step latency exceeds median x threshold; evict after K
strikes and trigger an elastic restart from the latest checkpoint).  In this
single-process container the same objects drive the control flow — the
trainer consults them every step and the restart path is exercised by tests
(kill -> restore -> bit-identical continuation).
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class HeartbeatRecord:
    host: int
    step: int
    t: float
    step_time: float


class Heartbeat:
    """Per-host liveness + step-latency reporting."""

    def __init__(self, host_id: int = 0):
        self.host = host_id
        self._last = time.monotonic()
        self.records: list[HeartbeatRecord] = []

    def beat(self, step: int, now: float | None = None,
             step_time: float | None = None) -> HeartbeatRecord:
        """Record a beat.  With no arguments the wall clock is read (the
        trainer path); a virtual-time caller (the serving engine) passes
        ``now``/``step_time`` explicitly so detection stays deterministic."""
        if now is None:
            now = time.monotonic()
        if step_time is None:
            step_time = now - self._last
        rec = HeartbeatRecord(self.host, step, now, step_time)
        self._last = now
        self.records.append(rec)
        if len(self.records) > 1000:
            del self.records[:500]
        return rec


@dataclasses.dataclass
class StragglerPolicy:
    """Median-based straggler detection with strike accumulation."""

    threshold: float = 2.0            # x median step time
    strikes_to_evict: int = 3
    window: int = 20

    def __post_init__(self):
        self._strikes: dict[int, int] = {}

    def observe(self, records: list[HeartbeatRecord]) -> dict[int, str]:
        """Returns {host: 'ok'|'straggler'|'evict'} for the latest window."""
        if not records:
            return {}
        recent = records[-self.window:]
        times = sorted(r.step_time for r in recent)
        median = times[len(times) // 2]
        verdict = {}
        last_by_host: dict[int, HeartbeatRecord] = {}
        for r in recent:
            last_by_host[r.host] = r
        for host, r in last_by_host.items():
            if median > 0 and r.step_time > self.threshold * median:
                self._strikes[host] = self._strikes.get(host, 0) + 1
                verdict[host] = ("evict" if self._strikes[host]
                                 >= self.strikes_to_evict else "straggler")
            else:
                self._strikes[host] = 0
                verdict[host] = "ok"
        return verdict


@dataclasses.dataclass
class RestartPolicy:
    """Bounded exponential-backoff restart budget."""

    max_restarts: int = 10
    backoff_base: float = 1.0
    backoff_cap: float = 60.0

    def __post_init__(self):
        self.restarts = 0

    def next_delay(self) -> float | None:
        """None => restart budget exhausted, fail the job."""
        if self.restarts >= self.max_restarts:
            return None
        delay = min(self.backoff_base * (2 ** self.restarts),
                    self.backoff_cap)
        self.restarts += 1
        return delay
