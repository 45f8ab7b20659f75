"""The N-core cluster sweep engine.

The port of the reference's ``repro/cluster/engine.py``.  It lifts the
single-core engine (``core/simulator.py``) to a cluster of N homogeneous
dispersion cores behind a shared L2 and banked memory channels
(``cluster/contention.py``):

  * every core runs the trace in lockstep with a private cVRF, L1 and
    spill state (worst-case-aligned contention);
  * each core runs the trace in its own **address colour**: core i's
    spill region and data lines are offset by ``i * stride`` (stride =
    the program footprint rounded up to odd, so per-core L1 set mappings
    genuinely differ while core 0 is untouched — the N=1 identity);
  * each row's L1-miss lines (``simulator.NUM_MISS_SITES`` sites a core)
    drain through the shared L2 in round-robin core order, and the
    survivors queue on the memory channels, charging each core a
    ``contention_stalls`` increment that is a latency-independent
    multiple of ``mem_latency``.

Counter layout: :data:`CLUSTER_COUNTER_NAMES` = the single-core
``COUNTER_NAMES`` + (``contention_stalls``, ``l2_hits``, ``l2_misses``).
``cycles`` absorbs the contention adjustment ``l2_hits * (l2_hit_cycles -
mem_latency) + contention_stalls`` per core, so per-core cycles stay
exactly affine in the machine latencies (:func:`check_cluster_affine`);
the *aggregate* cluster ``cycles`` is the makespan (max over cores).

The engine is ``kernels/cluster_scan.py``: K1 then K2 on the card (the
default), the plain twin with ``device="cpu"``.  Where the port differs
from the reference: one call takes any number of cluster points
(:func:`simulate_clusters`), and on the card K1 runs once for all of them,
since each core's single-core counters do not depend on the core count;
the reference's compile and dispatch counters have no counterpart (K2's
wrapper counts its launches, ``cluster_l2_cuda.launches``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.cluster.contention import ClusterConfig
from repro_torch.core import costmodel, isa, simulator
from repro_torch.core.simulator import (DEFAULT_MACHINE, MachineSweep,
                                        PreparedTrace, SweepConfig)
from repro_torch.device import resolve_device
from repro_torch.kernels import cluster_scan as k2
from repro_torch.kernels import engine_scan as k1

CLUSTER_COUNTER_NAMES = simulator.COUNTER_NAMES + (
    "contention_stalls", "l2_hits", "l2_misses",
)

# Aggregate-only outputs derived from the per-core cycles column.
CORE_CYCLE_AGGREGATES = ("core_cycles_min", "core_cycles_max",
                         "core_cycles_sum")


def _stride(prep: PreparedTrace) -> int:
    """Per-core address-colour stride: one core's whole footprint (spill
    region + data lines), rounded up to odd so consecutive colours land on
    different L1/L2 sets (set counts are powers of two)."""
    mem_max = int(np.max(prep.ev.mem_line, initial=-1))
    footprint = max(prep.spill_line0 + isa.NUM_ARCH_VREGS, mem_max + 1)
    return footprint | 1


def _run(preps, machines: MachineSweep, cfg, mach, clusters, track_ab,
         device):
    """One engine call over P prepared traces for every cluster point ->
    per point (ctr, ctr_a, ctr_b), (P, C, M, N, 15) int32 numpy."""
    lengths = [p.num_rows for p in preps]
    arrays, spill0s = simulator._stack(preps)
    strides = [_stride(p) for p in preps]
    x = k1.pack(arrays, device)
    outs = k2.cluster_scan(
        x, torch.as_tensor(spill0s, device=device), strides,
        tuple(torch.as_tensor(a, device=device) for a in cfg),
        tuple(torch.as_tensor(a, device=device) for a in mach), clusters,
        l1_sets=machines.l1_sets, l1_ways=machines.l1_ways,
        track_ab=track_ab, lengths=lengths)
    return [tuple(o.cpu().numpy() for o in out) for out in outs]


def _aggregate(ctr, ctrA, ctrB, preps, squeeze_m, return_per_core) -> dict:
    """The reference's cluster result from per-core counters (P, C, M, N,
    15): the makespan, numpy's int64 sums over cores, the fold
    certificate over every core's full counter vector."""
    if squeeze_m:                                   # (P, C, M, N, 15)
        ctr, ctrA, ctrB = ctr[:, :, 0], ctrA[:, :, 0], ctrB[:, :, 0]
    per_core = {k: ctr[..., i] for i, k in enumerate(CLUSTER_COUNTER_NAMES)}
    cyc = per_core["cycles"]
    out = {"cycles": cyc.max(axis=-1)}
    for name in CLUSTER_COUNTER_NAMES[1:]:
        out[name] = per_core[name].sum(axis=-1)
    out["core_cycles_min"] = cyc.min(axis=-1)
    out["core_cycles_max"] = cyc.max(axis=-1)
    out["core_cycles_sum"] = cyc.sum(axis=-1)
    grid_shape = out["cycles"].shape              # (P, C) or (P, C, M)
    per_prog = (-1,) + (1,) * (len(grid_shape) - 1)
    if any(p.num_folds for p in preps):
        steady = (ctrA == ctrB).all(axis=(-1, -2))
        steady &= np.asarray(
            [p.certifiable for p in preps]).reshape(per_prog)
        unfolded = np.asarray([p.num_folds == 0 for p in preps])
        steady[unfolded] = True
        out["fold_exact"] = steady
    total = out["vrf_hits"] + out["vrf_misses"]
    with np.errstate(divide="ignore", invalid="ignore"):
        out["hit_rate"] = np.where(total > 0, out["vrf_hits"] / total, 1.0)
    out["event_scale"] = np.broadcast_to(
        np.asarray([p.event_scale for p in preps]).reshape(per_prog),
        grid_shape).copy()
    if return_per_core:
        out["per_core"] = per_core
    return out


def simulate_clusters(preps: list, sweep: SweepConfig,
                      machine=DEFAULT_MACHINE, clusters=(ClusterConfig(),),
                      batch_programs: bool = False,
                      return_per_core: bool = False,
                      device="cuda") -> list[dict]:
    """:func:`simulate_cluster_grid` for several cluster points in one
    engine call: one result dict per point of ``clusters``.  On the card
    K1 runs once for all of them (a core's single-core counters do not
    depend on the core count), then K2 for every point."""
    dev = resolve_device(device)
    preps = [simulator.prepare(p) if not isinstance(p, PreparedTrace) else p
             for p in preps]
    clusters = list(clusters)
    squeeze_m = not isinstance(machine, MachineSweep)
    machines = MachineSweep.from_params([machine]) if squeeze_m else machine
    cfg = (np.asarray(sweep.capacity, np.int32),
           np.asarray(sweep.policy, np.int32),
           np.asarray(sweep.alloc_no_fetch, bool))
    mach = (np.asarray(machines.l1_hit_cycles, np.int32),
            np.asarray(machines.uop_hit_cycles, np.int32),
            np.asarray(machines.mem_latency, np.int32))
    if batch_programs:
        per = _run(preps, machines, cfg, mach, clusters,
                   any(p.num_folds for p in preps), dev)
    else:
        runs = [_run([prep], machines, cfg, mach, clusters,
                     prep.num_folds > 0, dev) for prep in preps]
        per = [tuple(np.concatenate([r[i][s] for r in runs])
                     for s in range(3)) for i in range(len(clusters))]
    return [_aggregate(*ctrs, preps, squeeze_m, return_per_core)
            for ctrs in per]


def simulate_cluster_grid(preps: list, sweep: SweepConfig,
                          machine=DEFAULT_MACHINE,
                          cluster: ClusterConfig = ClusterConfig(),
                          batch_programs: bool = False,
                          return_per_core: bool = False,
                          device="cuda") -> dict:
    """Cluster analogue of :func:`repro_torch.core.simulator.simulate_grid`.

    Returns (P, C) — or (P, C, M) under a :class:`MachineSweep` — arrays
    for every :data:`CLUSTER_COUNTER_NAMES` counter, aggregated over the N
    cores: ``cycles`` is the cluster **makespan** (max over cores, the
    time until the last core retires), every other counter is the sum.
    ``core_cycles_min/max/sum`` expose the per-core cycles spread (the
    fairness margin), and ``fold_exact`` / ``hit_rate`` / ``event_scale``
    carry over with their single-core semantics (a fold is certified only
    if A == B on *every* core's full counter vector).

    ``return_per_core=True`` additionally returns ``out["per_core"]``, a
    dict of (..., N) per-core counter grids — the input shape for
    :func:`check_cluster_affine`.  ``device`` is where the engine runs:
    ``"cuda"`` (the default) launches K1 and K2, ``"cpu"`` runs the twin.
    """
    return simulate_clusters(preps, sweep, machine, [cluster],
                             batch_programs=batch_programs,
                             return_per_core=return_per_core,
                             device=device)[0]


def check_cluster_affine(per_core: dict, machines: MachineSweep) -> dict:
    """Machine-latency affinity cross-check, per core.

    ``per_core`` is ``simulate_cluster_grid(..., return_per_core=True)
    ["per_core"]`` with shape (..., M, N).  Each core's ``cycles`` /
    ``stall_cycles`` / ``contention_stalls`` must be exactly affine in the
    machine latencies and every other counter machine-invariant — the L2
    and arbiter only ever consult hit/miss decisions.  The ``mem_latency``
    slope floor is ``l1_misses - l2_hits``: every L2 hit converts one
    memory transfer into a (static) ``l2_hit_cycles`` term, while channel
    queueing only adds whole ``mem_latency`` rounds on top.
    """
    cnt = {k: np.swapaxes(np.asarray(v), -1, -2)      # (..., N, M)
           for k, v in per_core.items()}
    floor = cnt["l1_misses"][..., 0] - cnt["l2_hits"][..., 0]
    return costmodel.check_machine_affine(
        cnt, machines,
        timing=("cycles", "stall_cycles", "contention_stalls"),
        mem_slope_floor=floor)
