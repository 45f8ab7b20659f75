"""Serving-scenario generator: seeded, replayable traffic for the engine.

Everything runs on a **virtual clock** (ticks = nominal decode steps), so a
scenario is a pure function of its :class:`TrafficConfig` and a seed —
every run is deterministic and bit-replayable, which is what lets the chaos
harness compare a faulted run against its fault-free twin request by
request.

Arrival processes:

  * ``poisson``  — memoryless arrivals at ``rate`` requests/tick;
  * ``mmpp``     — a 2-state Markov-modulated Poisson process: a *calm*
    state at ``rate`` and a *burst* state at ``rate * burst_factor``,
    switching with geometric dwell times — the bursty, correlated traffic
    real serving fleets see.

Requests are **multi-tenant**: each tenant maps to one model architecture
from :mod:`repro_torch.configs.registry` and carries its own prompt/output
length distributions — prefill-heavy tenants (VLM/audio: long prompts,
short outputs) mixed with decode-heavy ones (SSM/hybrid chat: short
prompts, long outputs), so one scenario exercises mixed prefill/decode the
way a shared fleet does.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs import registry

__all__ = [
    "VirtualClock", "Tenant", "TrafficConfig", "RequestSpec", "Scenario",
    "default_tenants", "TRAFFIC_MIXES", "generate",
]


class VirtualClock:
    """Deterministic virtual time in ticks (1 tick = one nominal decode
    step).  The engine advances it; nothing ever reads wall time, so runs
    are replayable regardless of host load."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def advance(self, dt: float) -> float:
        assert dt >= 0, f"virtual time cannot run backwards (dt={dt})"
        self.now += float(dt)
        return self.now

    def advance_to(self, t: float) -> float:
        if t > self.now:
            self.now = float(t)
        return self.now


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One traffic tenant: an architecture from the configs registry plus
    its sequence-length profile (geometric-ish lengths, clamped)."""

    name: str
    arch: str                       # key into repro_torch.configs.registry.ARCHS
    prompt_mean: float = 8.0
    prompt_max: int = 32
    decode_mean: float = 8.0
    decode_max: int = 32
    deadline: float | None = None   # ticks from admission; None = best-effort
    weight: float = 1.0             # relative arrival share


def default_tenants(max_len: int = 48, vocab: int = 512) -> tuple[Tenant, ...]:
    """One tenant per registry family, sequence-length profiles keyed by
    what the family is used for: prefill-heavy (vlm/audio: long prompts,
    short outputs), decode-heavy (ssm/hybrid: short prompts, long
    outputs), balanced (dense/moe chat)."""
    del vocab
    half = max(max_len // 2, 8)
    profiles = {
        "dense":  dict(prompt_mean=half * 0.3, decode_mean=half * 0.5,
                       deadline=None, weight=3.0),
        "moe":    dict(prompt_mean=half * 0.4, decode_mean=half * 0.4,
                       deadline=None, weight=1.0),
        "ssm":    dict(prompt_mean=half * 0.15, decode_mean=half * 0.8,
                       deadline=None, weight=2.0),
        "hybrid": dict(prompt_mean=half * 0.15, decode_mean=half * 0.7,
                       deadline=None, weight=1.0),
        "vlm":    dict(prompt_mean=half * 0.8, decode_mean=half * 0.2,
                       deadline=None, weight=1.0),
        "audio":  dict(prompt_mean=half * 0.7, decode_mean=half * 0.25,
                       deadline=None, weight=1.0),
    }
    seen: dict[str, Tenant] = {}
    for name, cfg in registry.ARCHS.items():
        if cfg.family in seen:
            continue
        p = profiles.get(cfg.family, profiles["dense"])
        seen[cfg.family] = Tenant(
            name=cfg.family, arch=name,
            prompt_mean=max(p["prompt_mean"], 1.0),
            prompt_max=max_len // 2,
            decode_mean=max(p["decode_mean"], 1.0),
            decode_max=max_len // 2,
            deadline=p["deadline"], weight=p["weight"])
    return tuple(seen[f] for f in sorted(seen))


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """A declarative traffic mix; ``generate(cfg, seed)`` makes it a
    concrete :class:`Scenario`."""

    name: str = "steady"
    arrival: str = "poisson"        # poisson | mmpp
    rate: float = 0.25              # requests per tick (calm state)
    burst_factor: float = 6.0       # mmpp: burst-state rate multiplier
    p_enter_burst: float = 0.02     # mmpp: calm -> burst per tick
    p_exit_burst: float = 0.15      # mmpp: burst -> calm per tick
    n_requests: int = 16
    tenants: tuple[Tenant, ...] = ()
    deadline: float | None = None   # default deadline for tenants without
    vocab: int = 512
    max_len: int = 48

    def __post_init__(self):
        if self.arrival not in ("poisson", "mmpp"):
            raise ValueError(
                f"arrival must be 'poisson' or 'mmpp', got {self.arrival!r}")
        if not self.tenants:
            object.__setattr__(self, "tenants",
                               default_tenants(self.max_len, self.vocab))


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """One immutable arrival: everything needed to materialise a fresh
    ``Request``, so a scenario can be replayed (fault-free vs chaos) from
    identical inputs."""

    rid: int
    t: float
    tenant: str
    prompt: tuple[int, ...]
    max_new_tokens: int
    deadline: float | None


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A seeded, replayable serving scenario: sorted arrival specs."""

    config: TrafficConfig
    seed: int
    arrivals: tuple[RequestSpec, ...]

    @property
    def horizon(self) -> float:
        return self.arrivals[-1].t if self.arrivals else 0.0

    def requests(self):
        """Fresh mutable Request objects for one run (import here: engine
        imports traffic for the clock, so the reverse import is lazy)."""
        from repro_torch.serve.engine import Request
        return [Request(prompt=list(s.prompt),
                        max_new_tokens=s.max_new_tokens, rid=s.rid,
                        tenant=s.tenant, arrival_t=s.t, deadline=s.deadline)
                for s in self.arrivals]


def _interarrival_times(cfg: TrafficConfig, rng) -> np.ndarray:
    """Virtual-tick arrival times for ``cfg.n_requests`` requests."""
    if cfg.arrival == "poisson":
        gaps = rng.exponential(1.0 / cfg.rate, cfg.n_requests)
        return np.cumsum(gaps)
    # MMPP-2: walk tick by tick; each tick in state s arrivals ~ thinned
    # exponential stream at rate_s.  Implemented as per-request gap draws
    # with the modulating chain advanced underneath the exponential draw.
    times = []
    t = 0.0
    burst = False
    for _ in range(cfg.n_requests):
        while True:
            rate = cfg.rate * (cfg.burst_factor if burst else 1.0)
            gap = rng.exponential(1.0 / rate)
            # chain switches are checked per elapsed tick of the gap
            switch_p = cfg.p_exit_burst if burst else cfg.p_enter_burst
            n_ticks = max(int(gap), 1)
            flips = rng.random(n_ticks) < switch_p
            if flips.any():
                # the chain flipped mid-gap: advance to the flip and redraw
                t += float(np.argmax(flips) + 1)
                burst = not burst
                continue
            t += gap
            break
        times.append(t)
    return np.asarray(times)


def _draw_len(rng, mean: float, lo: int, hi: int) -> int:
    """Geometric length draw with the given mean, clamped to [lo, hi]."""
    p = min(max(1.0 / max(mean, 1.0), 1e-6), 1.0)
    return int(np.clip(rng.geometric(p), lo, hi))


def generate(cfg: TrafficConfig, seed: int = 0) -> Scenario:
    """The one entry point: a deterministic scenario from (config, seed)."""
    rng = np.random.default_rng(seed)
    times = _interarrival_times(cfg, rng)
    weights = np.asarray([t.weight for t in cfg.tenants], np.float64)
    weights /= weights.sum()
    specs = []
    for rid, t in enumerate(times):
        ten = cfg.tenants[int(rng.choice(len(cfg.tenants), p=weights))]
        n_prompt = _draw_len(rng, ten.prompt_mean, 1, ten.prompt_max)
        n_out = _draw_len(rng, ten.decode_mean, 1, ten.decode_max)
        prompt = tuple(int(x) for x in
                       rng.integers(1, cfg.vocab, n_prompt))
        deadline = ten.deadline if ten.deadline is not None else cfg.deadline
        specs.append(RequestSpec(rid=rid, t=float(t), tenant=ten.name,
                                 prompt=prompt, max_new_tokens=n_out,
                                 deadline=deadline))
    return Scenario(config=cfg, seed=seed, arrivals=tuple(specs))


# Named mixes the SLO benchmark sweeps over.  ``steady`` is uniform Poisson
# load; ``bursty`` is the MMPP regime where admission control earns its
# keep; ``decode_heavy`` skews the tenant mix to long decodes (KV pressure).
TRAFFIC_MIXES: dict[str, TrafficConfig] = {
    "steady": TrafficConfig(name="steady", arrival="poisson", rate=0.20),
    "bursty": TrafficConfig(name="bursty", arrival="mmpp", rate=0.10,
                            burst_factor=8.0),
    "decode_heavy": TrafficConfig(
        name="decode_heavy", arrival="poisson", rate=0.15,
        tenants=tuple(dataclasses.replace(t, decode_mean=t.decode_mean * 2,
                                          weight=(3.0 if t.name in
                                                  ("ssm", "hybrid")
                                                  else t.weight))
                      for t in default_tenants())),
}
