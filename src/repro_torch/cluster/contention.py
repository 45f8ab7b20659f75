"""Shared-memory contention model for clustered vector cores.

The port of the reference's ``repro/cluster/contention.py``.  A cluster
(Spatz-style, arXiv:2309.10137) puts N homogeneous dispersion cores —
each with its private cVRF + L1 — behind one shared L2 and a banked
main-memory interface.  This module holds the *static* cluster
description and the pieces the engine composes per instruction row:

  * a shared **L2 lookup** (sets x ways, LRU, read-allocate on demand
    misses; dirty L1 writebacks are absorbed by a write buffer and
    bypass both the L2 and the arbiter), and
  * a deterministic **round-robin banked-channel arbiter**: the L1-miss
    streams that also miss the L2 contend for ``mem_channels`` memory
    banks.  Requests issued in the same lockstep instruction slot are
    served in round-robin core order (the RR pointer advances one core
    per instruction), each bank serving one request per ``mem_latency``
    window; a request finding ``b`` earlier-ranked requests queued waits
    ``(b // mem_channels) * mem_latency`` extra cycles.

Only *cross-core* queueing is charged here: the single-core engine
already serializes a core's own misses at ``mem_latency`` each, so the
arbiter's exclusive-cumsum over earlier-ranked cores never double-counts
— and an N=1 cluster gets identically zero contention.

Every quantity the arbiter derives (L2 hits, queue rounds) depends only
on hit/miss *decisions*, never on the latency values, so cluster cycle
counts stay affine in the machine latencies and
``costmodel.check_machine_affine`` extends to the cluster
(:func:`repro_torch.cluster.engine.check_cluster_affine`).

The functions are torch versions of the reference's, over a leading
batch of lanes where one is given; the engine's plain twin
(``kernels/cluster_scan.py``) runs them, the card runs K2.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import simulator


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Static description of one cluster of dispersion cores.

    The per-core cVRF capacity/policy stays on the existing
    :class:`repro_torch.core.simulator.SweepConfig` axis and the L1
    geometry + latencies on :class:`~repro_torch.core.simulator.MachineSweep`;
    this class only adds what is *shared*: the L2 and the memory
    channels.  ``l2_hit_cycles`` is static (not a latency axis) so
    cluster cycles remain affine in the three machine latencies.
    """

    n_cores: int = 1
    l2_sets: int = 0          # 0 => no shared L2 (pass-through to memory)
    l2_ways: int = 4
    mem_channels: int = 1     # memory banks serving one request / latency
    l2_hit_cycles: int = 2    # static: replaces mem_latency on an L2 hit

    def __post_init__(self):
        if self.n_cores < 1:
            raise ValueError(f"n_cores must be >= 1, got {self.n_cores}")
        if self.mem_channels < 1:
            raise ValueError(
                f"mem_channels must be >= 1, got {self.mem_channels}")
        if self.l2_sets and self.l2_sets & (self.l2_sets - 1):
            raise ValueError(
                f"l2_sets must be 0 or a power of two, got {self.l2_sets}")

    @staticmethod
    def passthrough(n_cores: int = 1) -> "ClusterConfig":
        """The identity cluster: no shared L2 and enough channels that the
        arbiter can never queue (a step issues at most NUM_MISS_SITES
        requests per core, so ``n_cores * NUM_MISS_SITES`` banks make every
        exclusive-cumsum queue depth round down to zero).  An N=1
        passthrough cluster reproduces the single-core engine's counters
        bit-exactly."""
        return ClusterConfig(
            n_cores=n_cores, l2_sets=0, l2_ways=1,
            mem_channels=n_cores * simulator.NUM_MISS_SITES)

    @property
    def l2_bytes(self) -> int:
        """Shared-L2 data capacity (32 B lines, matching the L1 model)."""
        return self.l2_sets * self.l2_ways * 32


def l2_init(l2_sets: int, l2_ways: int, lanes: int | None = None,
            device="cpu") -> torch.Tensor:
    """Shared-L2 state: (sets, ways, 2) int32 — (lanes, sets, ways, 2) for
    a batch of lanes — with [..., 0] the line tag (-1 free) and [..., 1]
    the LRU age, an access clock (the engine starts it at 1, so a filled
    way never ties with a free one)."""
    shape = (max(l2_sets, 1), l2_ways, 2)
    l2 = torch.zeros(shape if lanes is None else (lanes,) + shape,
                     dtype=torch.int32, device=device)
    l2[..., 0] = -1
    return l2


def l2_access(l2, line, clock, l2_sets: int):
    """One shared-L2 probe for an L1-missed ``line`` (-1, or any negative
    line: no request), per lane when ``l2`` carries a leading lane axis
    (``line`` and ``clock`` then (lanes,)).

    Returns ``(l2, hit)``; ``l2`` is updated in place.  LRU within the set
    (a hit takes the first matching way, a miss the first way of least
    age), allocate on miss; inactive requests change nothing.  Hit/miss
    decisions depend only on the request stream, never on latencies."""
    one = l2.dim() == 3
    if one:
        l2 = l2[None]
    line = torch.as_tensor(line, dtype=torch.int32,
                           device=l2.device).reshape(-1)
    clock = torch.as_tensor(clock, dtype=torch.int32,
                            device=l2.device).reshape(-1)
    lanes = torch.arange(l2.shape[0], device=l2.device)
    active = line >= 0
    set_idx = torch.where(active, line, 0) % l2_sets
    row = l2[lanes, set_idx]                            # (lanes, ways, 2)
    eq = row[..., 0] == line[:, None]
    hit, hit_way = eq.max(dim=1)
    hit &= active
    way = torch.where(hit, hit_way, row[..., 1].argmin(dim=1))
    new = torch.stack([line, clock.expand_as(line)], dim=1)
    at = (lanes[active], set_idx[active], way[active])
    l2[at] = new[active]
    return (l2[0], hit[0]) if one else (l2, hit)


def rank_order(n_cores: int, t) -> torch.Tensor:
    """Round-robin service order for stored row ``t``: rank r is served
    r-th this step, and ``rank_order(...)[r]`` is the core holding that
    rank.  The RR pointer advances one core per row so every core
    periodically goes first."""
    return (t % n_cores + torch.arange(n_cores)) % n_cores


def queue_rounds(reqs_rr, mem_channels: int) -> torch.Tensor:
    """Banked-channel queue depth per rank (last axis): with requests
    served in rank order, one per channel per ``mem_latency`` window, rank
    r's requests wait behind the exclusive cumsum of earlier ranks'
    requests and stall ``(before // mem_channels)`` full memory latencies.
    Rank 0 (and all of an N=1 cluster) always gets 0."""
    reqs_rr = torch.as_tensor(reqs_rr)
    before = torch.cumsum(reqs_rr, dim=-1) - reqs_rr
    return torch.div(before, mem_channels, rounding_mode="floor")
