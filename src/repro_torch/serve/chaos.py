"""Fault injection for the serving engine: latency spikes, transient slot
failures, and live memory-pressure events — all on the virtual clock, all
seeded, so a chaotic run is exactly replayable and comparable against its
fault-free twin.

The injector does not bypass the engine's control plane; it *drives* it:

  * ``latency_spike``  — multiplies the virtual duration of every decode
    step in its window (a slow accelerator / noisy neighbour); global
    spikes shift the whole latency distribution but trip no eviction,
    because :class:`repro_torch.runtime.fault_tolerance.StragglerPolicy` is
    median-based.
  * ``slot_fail``      — freezes one batching slot for a window: the slot
    stops making progress (the engine rolls its cache slice back each
    step, so no state corruption), its heartbeat step-time inflates, and
    the engine's straggler policy accumulates strikes until it *evicts*
    the slot — preempting the victim request (KV spilled to cold) and
    re-admitting it later, bit-identically.
  * ``mem_pressure``   — shrinks the hot KV pool live
    (:meth:`DispersedKVPool.shrink`): policy-selected victims are force-
    spilled and service continues from the smaller pool — the paper's
    graceful-degradation bet, measured while it happens.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["FaultEvent", "FaultProfile", "FaultInjector", "make_profile",
           "FAULT_PROFILES", "KINDS"]

KINDS = ("latency_spike", "slot_fail", "mem_pressure")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``t`` is virtual ticks; meaning of the rest
    depends on ``kind``:

      latency_spike: ``magnitude`` x step duration for ``duration`` ticks
      slot_fail:     slot ``slot`` frozen for ``duration`` ticks
      mem_pressure:  hot pool shrunk to ``magnitude`` pages (int)
    """

    t: float
    kind: str
    duration: float = 0.0
    magnitude: float = 1.0
    slot: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got "
                             f"{self.kind!r}")


@dataclasses.dataclass(frozen=True)
class FaultProfile:
    """A named, immutable fault schedule (events sorted by time)."""

    name: str
    events: tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(
            self, "events", tuple(sorted(self.events, key=lambda e: e.t)))


def make_profile(name: str, *, seed: int = 0, horizon: float = 200.0,
                 slots: int = 4, spike_rate: float = 0.0,
                 spike_magnitude: float = 4.0, spike_duration: float = 3.0,
                 n_slot_fails: int = 0, fail_duration: float = 8.0,
                 shrink_at_frac: float | None = None,
                 shrink_to: int = 0) -> FaultProfile:
    """Seeded schedule generator.  ``spike_rate`` is spikes per tick
    (Poisson); slot failures and the (single) shrink are placed uniformly /
    at ``shrink_at_frac * horizon``."""
    rng = np.random.default_rng(seed)
    events: list[FaultEvent] = []
    if spike_rate > 0:
        t = float(rng.exponential(1.0 / spike_rate))
        while t < horizon:
            events.append(FaultEvent(t=t, kind="latency_spike",
                                     duration=spike_duration,
                                     magnitude=spike_magnitude))
            t += float(rng.exponential(1.0 / spike_rate))
    for _ in range(n_slot_fails):
        events.append(FaultEvent(
            t=float(rng.uniform(0.1 * horizon, 0.8 * horizon)),
            kind="slot_fail", duration=fail_duration,
            slot=int(rng.integers(0, slots))))
    if shrink_at_frac is not None:
        events.append(FaultEvent(t=float(shrink_at_frac * horizon),
                                 kind="mem_pressure",
                                 magnitude=int(shrink_to)))
    return FaultProfile(name=name, events=tuple(events))


class FaultInjector:
    """Replays a :class:`FaultProfile` against a ``ServeEngine``.

    The engine calls :meth:`apply` once per step (before decoding) with
    itself and the current virtual time; due events mutate the engine
    through its public fault surface (``fail_slot`` / ``shrink_pool``) or
    this injector's spike window, which the engine reads via
    :meth:`latency_multiplier`.
    """

    def __init__(self, profile: FaultProfile):
        self.profile = profile
        self._next = 0
        self._spike_until = -1.0
        self._spike_mult = 1.0
        self.applied: list[FaultEvent] = []

    def reset(self) -> None:
        self._next = 0
        self._spike_until = -1.0
        self._spike_mult = 1.0
        self.applied = []

    def latency_multiplier(self, now: float) -> float:
        return self._spike_mult if now < self._spike_until else 1.0

    def fault_active(self, now: float) -> bool:
        """Whether any injected fault window covers ``now`` (the flag SLO
        accounting uses for degraded-mode throughput)."""
        return now < self._spike_until or bool(self.applied) and any(
            e.kind != "latency_spike" and e.t <= now < e.t + max(
                e.duration, 1.0)
            for e in self.applied)

    def apply(self, engine, now: float) -> list[FaultEvent]:
        """Fire every event with ``t <= now``; returns the fired events."""
        fired = []
        evs = self.profile.events
        while self._next < len(evs) and evs[self._next].t <= now:
            e = evs[self._next]
            self._next += 1
            if e.kind == "latency_spike":
                # overlapping spikes extend the window, max magnitude wins
                self._spike_mult = max(
                    self._spike_mult if now < self._spike_until else 1.0,
                    e.magnitude)
                self._spike_until = max(self._spike_until,
                                        now + e.duration)
            elif e.kind == "slot_fail":
                engine.fail_slot(e.slot % engine.slots,
                                 until=now + e.duration)
            elif e.kind == "mem_pressure":
                engine.shrink_pool(int(e.magnitude))
            self.applied.append(e)
            fired.append(e)
        return fired


# Named profiles the SLO benchmark sweeps over.  They are *factories* over
# (horizon, slots, hot pages) because a schedule only means something
# relative to the scenario it fires into.
def _none(horizon, slots, hot_pages, seed=0):
    del horizon, slots, hot_pages, seed
    return FaultProfile(name="none")


def _spikes(horizon, slots, hot_pages, seed=0):
    del hot_pages
    return make_profile("spikes", seed=seed, horizon=horizon, slots=slots,
                        spike_rate=0.03, spike_magnitude=5.0,
                        spike_duration=4.0)


def _chaos(horizon, slots, hot_pages, seed=0):
    """The acceptance scenario: latency spikes + one forced hot-pool
    shrink + a transient slot failure."""
    base = make_profile("chaos", seed=seed, horizon=horizon, slots=slots,
                        spike_rate=0.02, spike_magnitude=4.0,
                        spike_duration=3.0, n_slot_fails=1,
                        fail_duration=10.0, shrink_at_frac=0.4,
                        shrink_to=max(hot_pages - hot_pages // 3,
                                      slots + 2))
    return base


FAULT_PROFILES = {"none": _none, "spikes": _spikes, "chaos": _chaos}
