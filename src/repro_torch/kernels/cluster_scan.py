"""The cluster scan (K2): a CUDA kernel, its wrapper and its plain versions.

Port of the reference's cluster engine, ``repro/cluster/engine.py``
``_run_cluster_grid`` (a ``lax.scan`` whose step vmaps the single-core
body over N lockstep cores, then drains their L1-miss lines through
``contention.l2_access`` in ``rank_order`` and charges ``queue_rounds``).
XLA compiles it from a scan body, so it has no ``pallas_call``; on Hopper
it is hand-written, ``csrc/cluster_scan.cu``, on top of K1
(``kernels/engine_scan.py``).

What lets it stand on K1: core c runs the same trace with every spill and
data line shifted by ``c * stride`` (its address colour).  Sets are a
power of two and the L1 is private, so a constant shift only rotates the
sets and keeps tag equality: while no shifted line leaves [0, 2^31)
(:func:`address_invariant`), every core's cVRF and L1 decisions, and its
12 single-core counters, are core 0's, and core 0's are K1's.  A cluster
point is then K1 once per (program, cVRF class) lane, for every core
count, and K2: a pass over the shared L2 and the arbiter that reads N
shifted copies of the lane's L1-miss stream, which K1b already wrote (its
bucketed records and their outcome bytes).  A program whose lines would
leave that range gets one K1b lane per core, each with its own base, and
K2 reads each core's own stream: nothing is approximated.

K2 on the card, one launch: the L1 misses back into engine order; per
(K2 lane, tile of rows) a warp counts each (row, rank)'s requests and the
requests per L2 set, an exclusive scan, the same warps scatter each
request in (row, rank, site) order to its (lane, L2 set) bucket; one
thread per bucket walks it through the set's ways with a local clock (the
L2 decides from the order within a set only) and moves each hit from
the (row, rank)'s request count to its hit count; per (lane, row) the
arbiter's exclusive scan over ranks and ``// mem_channels``, summed per
core times ``wt``/``wa``/``wb``; the closed form per (output, machine,
core) adds K1's counters.

Plain versions: :func:`cluster_scan_plain`, the twin, a separate
formulation of the reference's lockstep step (K1's one-walk twin with N
core lanes, each walking its own L1, and the L2 probed per site with
``contention.l2_access``): it assumes no shift invariance, and it is the
CPU path.  :func:`cluster_l2_plain`, K2's counterpart in the split: it
takes K1b's plain accesses and outcomes (``engine_scan.l1_accesses``,
``l1_outcomes``), expands them to N cores and walks by L2 set; composed
with K1's plain halves it is :func:`cluster_split_plain`, K2's oracle on
the card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.cluster import contention
from repro_torch.core.isa import NUM_ARCH_VREGS
from repro_torch.kernels import engine_scan as k1
from repro_torch.kernels.engine_scan import (CYCLES, ML, MV, NUM_COUNTERS,
                                             NUM_SETS, REG_COUNTERS,
                                             REG_SITES, SITES, WB, WT,
                                             _int32_on, _launch, _ptrs,
                                             _rows_on_card, _wrap32)
from repro_torch.kernels.routes import RouteCounted

# Per-core counters: K1's 12 (simulator.COUNTER_NAMES), then
# contention_stalls, l2_hits, l2_misses
CLUSTER_COUNTERS = NUM_COUNTERS + 3
# K2's sums per (lane, core, counter set): weighted L2 hits, requests that
# missed the L2, queue rounds
K2_SUMS = 3
# A row's requests and hits per rank pack into one byte each of a 64-bit
# word, so a K2 lane takes at most 8 cores
MAX_CORES = 8
# The kernel's tiles (csrc/cluster_scan.cu): rows a bucketing warp takes,
# bucketing warps a CTA (each with a shared counter per L2 set), walkers
# a CTA
K2_TILE_ROWS = 256
K2_HIST_WARPS = 4
K2_WALK_THREADS = 128
TILE_KEYS = ("tile_rows", "hist_warps_per_cta", "hist_smem_bytes",
             "way_slots", "walk_threads", "max_cores")
# Bytes a bucketed request takes: line and row << 3 | rank
REQUEST_BYTES = 8


def _cluster(cl) -> tuple[int, int, int, int, int]:
    """A ClusterConfig (or anything with its fields) as the tuple
    (n_cores, l2_sets, l2_ways, mem_channels, l2_hit_cycles)."""
    if isinstance(cl, tuple):
        return tuple(int(v) for v in cl)
    return (int(cl.n_cores), int(cl.l2_sets), int(cl.l2_ways),
            int(cl.mem_channels), int(cl.l2_hit_cycles))


def address_invariant(x, spill0s, strides, lengths, n_cores: int):
    """Per program, whether ``n_cores`` cores see core 0's trace shifted
    exactly: every line core 0 may touch (its spill region and its active
    MEM lines) is non-negative and stays below 2^31 after the largest
    shift, ``(n_cores - 1) * stride``.  Then the sets rotate, tags keep
    their equality and sign, and each core's decisions are core 0's."""
    P, T, _ = x.shape
    dev = x.device
    rows = torch.as_tensor(lengths, device=dev).to(torch.long)
    walked = torch.arange(T, device=dev)[None] < rows[:, None]
    act = (x[..., MV:MV + 2] != 0) & walked[..., None]
    lines = x[..., ML:ML + 2].to(torch.long)
    big, small = 2 ** 40, -2 ** 40
    hi = torch.where(act, lines, small).amax(dim=(1, 2))
    lo = torch.where(act, lines, big).amin(dim=(1, 2))
    sp0 = torch.as_tensor(spill0s, device=dev).to(torch.long)
    hi = torch.maximum(hi, sp0 + NUM_ARCH_VREGS - 1)
    lo = torch.minimum(lo, sp0)
    shift = (n_cores - 1) * torch.as_tensor(strides, device=dev).to(
        torch.long)
    return ((lo >= 0) & (hi + shift < 2 ** 31)).tolist()


def cluster_scan_plan(l1_sets: int, l1_ways: int, lengths, cfg, clusters, *,
                      strides, invariant, T: int | None = None) -> dict:
    """The work the card runs for the cluster points ``clusters`` over
    programs of ``lengths`` rows (padded to ``T``), configs ``cfg`` and an
    L1 of ``l1_sets`` x ``l1_ways``: K2's tile, each config's cVRF class,
    the widest L2's sets, and the launch groups.  A
    group holds whole programs (consecutive, under
    :data:`engine_scan.STREAM_BUDGET_BYTES` of K1's and K2's buffers
    together; a program alone may exceed it) and lists

    * ``reg_lanes`` (program, cVRF class): K1a's;
    * ``l1_lanes`` (program, class, K1a lane or -1, line base): K1b's, one
      per class, or one per core with base ``c * stride`` where the
      program is not :func:`address_invariant`;
    * ``k1_outputs`` (program, config, K1b lane): K1's counters, once for
      every core count;
    * ``k2_lanes`` (program, class, cluster point, each core's K1b lane,
      each core's shift): K2's, each core's L1-miss stream its K1b lane's
      shifted by its shift (``c * stride`` on a shared lane, else 0);
    * ``k2_outputs`` (program, config, cluster point, K2 lane, each core's
      K1 output);

    and the bytes of its buffers.  Raises ``ValueError`` for what the
    kernels do not take: more than :data:`MAX_CORES` cores, L2 ways
    outside 1..32, L2 sets whose bucketing counters pass the CTA's shared
    memory, and whatever K1 refuses."""
    k1.engine_scan_plan(l1_sets, l1_ways)        # raises on what K1 refuses
    lengths = [int(n) for n in lengths]
    T = max(lengths, default=0) if T is None else int(T)
    if T >= k1.MAX_ROWS:
        raise ValueError(f"cluster_scan takes fewer than {k1.MAX_ROWS} rows,"
                         f" got {T}")
    clusters = [_cluster(c) for c in clusters]
    if not clusters:
        raise ValueError("cluster_scan needs at least one cluster point")
    S = max(1, max(c[1] for c in clusters))
    ways = max((c[2] for c in clusters if c[1]), default=1)
    hist_smem = K2_HIST_WARPS * S * 4
    for n, sets, w, chan, _ in clusters:
        if not 1 <= n <= MAX_CORES or chan < 1 or (
                sets and not 1 <= w <= 32) or hist_smem > k1.MAX_SMEM_BYTES:
            raise ValueError(
                f"cluster_scan takes 1..{MAX_CORES} cores, 1..32 L2 ways and "
                f"at most {k1.MAX_SMEM_BYTES} bytes of bucketing counters, "
                f"got {n} cores x {sets} sets x {w} ways, {chan} channels "
                f"({hist_smem} bytes)")
    tile = dict(tile_rows=K2_TILE_ROWS, hist_warps_per_cta=K2_HIST_WARPS,
                hist_smem_bytes=hist_smem,
                way_slots=1 << (ways - 1).bit_length(),
                walk_threads=K2_WALK_THREADS, max_cores=MAX_CORES)
    nmax = max(c[0] for c in clusters)
    classes = k1.cvrf_classes(*cfg)
    kinds = list(dict.fromkeys(classes))
    tiles1 = k1._tiles(T)
    tiles2 = max(1, -(-T // K2_TILE_ROWS))
    groups, group = [], None
    for p, rows in enumerate(lengths):
        cores1 = 1 if invariant[p] else nmax
        need = dict.fromkeys(("stream", "records", "hist", "misses",
                              "counts", "requests", "l2_hist"), 0)
        fam = dict(reg_lanes=[], l1_lanes=[], k1_outputs=[], k2_lanes=[],
                   k2_outputs=[])
        for k in kinds:
            nsites = SITES if k >= 0 else 2
            reg = -1
            if k >= 0:
                reg = len(fam["reg_lanes"])
                fam["reg_lanes"].append((p, k))
                need["stream"] += T * REG_SITES
            lanes = []
            for c in range(cores1):
                lanes.append(len(fam["l1_lanes"]))
                fam["l1_lanes"].append((p, k, reg,
                                        k1._i32(c * int(strides[p]))))
            need["records"] += cores1 * rows * nsites * k1.RECORD_BYTES
            need["hist"] += cores1 * l1_sets * tiles1 * 4
            need["misses"] += cores1 * rows * nsites * 4
            outs = {}
            for c, kc in enumerate(classes):
                if kc == k:
                    outs[c] = []
                    for j in lanes:
                        outs[c].append(len(fam["k1_outputs"]))
                        fam["k1_outputs"].append((p, c, j))
            for i, (n, *_rest) in enumerate(clusters):
                kl = len(fam["k2_lanes"])
                if cores1 == 1:
                    l1s = [lanes[0]] * n
                    shifts = [k1._i32(c * int(strides[p]))
                              for c in range(n)]
                    at = [0] * n
                else:
                    l1s, shifts, at = lanes[:n], [0] * n, list(range(n))
                fam["k2_lanes"].append((p, k, i, l1s, shifts))
                fam["k2_outputs"] += [(p, c, i, kl, [q1[a] for a in at])
                                      for c, q1 in outs.items()]
                need["counts"] += T * 8
                need["requests"] += n * rows * nsites * REQUEST_BYTES
                need["l2_hist"] += S * tiles2 * 4
        if group is None or (group["k2_lanes"] and sum(
                group["bytes"].values()) + sum(need.values())
                > k1.STREAM_BUDGET_BYTES):
            group = dict(reg_lanes=[], l1_lanes=[], k1_outputs=[],
                         k2_lanes=[], k2_outputs=[],
                         bytes=dict.fromkeys(need, 0))
            groups.append(group)
        _append_family(group, fam)
        for key, v in need.items():
            group["bytes"][key] += v
    for g in groups:
        if g["bytes"]["requests"] >= 2 ** 31 * REQUEST_BYTES:
            raise ValueError("cluster_scan takes fewer than 2^31 requests "
                             "a launch group")
    return dict(route="l2set", tile=tile, classes=classes, l2_sets=S,
                groups=groups, budget_bytes=k1.STREAM_BUDGET_BYTES)


def _append_family(group, fam) -> None:
    """Add one program's lanes to a group, renumbering their indices."""
    r0, j0, q0, k0 = (len(group[key]) for key in (
        "reg_lanes", "l1_lanes", "k1_outputs", "k2_lanes"))
    group["reg_lanes"] += fam["reg_lanes"]
    group["l1_lanes"] += [(p, k, r + r0 if r >= 0 else -1, base)
                          for p, k, r, base in fam["l1_lanes"]]
    group["k1_outputs"] += [(p, c, j + j0) for p, c, j in fam["k1_outputs"]]
    group["k2_lanes"] += [(p, k, i, [j + j0 for j in l1s], shifts)
                          for p, k, i, l1s, shifts in fam["k2_lanes"]]
    group["k2_outputs"] += [(p, c, i, kl + k0, [q + q0 for q in q1s])
                            for p, c, i, kl, q1s in fam["k2_outputs"]]


# ------------------------------------------------------------ the twin --

def _l2_hook(clusters_tuple, P, C, M, mem_latency, device):
    """The cluster's row step for ``engine_scan_plain``'s N core lanes of
    each (program, config, machine) group: the rows' L1-missed lines
    drain through the shared L2 in rank order, the requests that miss it
    queue on the channels, and each core's increments gain its
    contention: the reference's step, group by group in one batch."""
    n, sets, ways, chan, hit_cycles = clusters_tuple
    G = P * C * M
    lat = torch.as_tensor(mem_latency, dtype=torch.int32,
                          device=device).repeat(P * C)             # (G,)
    l2 = contention.l2_init(sets, ways, G, device)
    clock = torch.ones(G, dtype=torch.int32, device=device)

    def hook(t, inc, miss):
        order = contention.rank_order(n, t).to(device)
        lines = miss.view(G, n, SITES)[:, order].reshape(G, n * SITES)
        req = lines >= 0
        hits = torch.zeros_like(req)
        if sets:
            for k in torch.nonzero(req.any(dim=0)).flatten().tolist():
                _, hits[:, k] = contention.l2_access(l2, lines[:, k], clock,
                                                     sets)
                clock.add_(req[:, k].to(torch.int32))
        hits = hits.view(G, n, SITES)
        l2h_rr = hits.sum(dim=2, dtype=torch.int32)
        reqs_rr = (req.view(G, n, SITES) & ~hits).sum(dim=2,
                                                      dtype=torch.int32)
        q_rr = contention.queue_rounds(reqs_rr, chan)
        l2h, reqs, q = (torch.empty_like(a) for a in (l2h_rr, reqs_rr, q_rr))
        l2h[:, order], reqs[:, order], q[:, order] = l2h_rr, reqs_rr, q_rr
        stall = q * lat[:, None]
        inc = inc.view(G, n, NUM_COUNTERS).clone()
        inc[..., CYCLES] += stall + l2h * (hit_cycles - lat[:, None])
        return torch.cat([inc, stall[..., None], l2h[..., None],
                          reqs[..., None]], dim=2).view(G * n, -1)
    return hook


def cluster_scan_plain(x, spill0s, strides, cfg, mach, clusters, *,
                       l1_sets: int, l1_ways: int, track_ab: bool = True,
                       lengths=None):
    """The twin: for each cluster point, the reference's lockstep step in
    plain torch — K1's one-walk twin (``engine_scan.engine_scan_plain``)
    over N core lanes of each (program, config, machine) lane, core c's
    lines shifted by ``c * strides[p]``, each core walking its own cVRF
    and L1, then per row the L2 probed site by site in rank order and the
    arbiter (:func:`_l2_hook`).  Returns one ``(ctr, ctr_a, ctr_b)`` per
    cluster point, (P, C, M, N, 15) int32 each."""
    P = x.shape[0]
    C = len(np.asarray(torch.as_tensor(cfg[0]).cpu()))
    M = len(np.asarray(torch.as_tensor(mach[0]).cpu()))
    out = []
    for cl in map(_cluster, clusters):
        out.append(k1.engine_scan_plain(
            x, spill0s, cfg, mach, l1_sets=l1_sets, l1_ways=l1_ways,
            track_ab=track_ab, lengths=lengths, cores=cl[0],
            strides=strides, width=CLUSTER_COUNTERS,
            row_hook=_l2_hook(cl, P, C, M, torch.as_tensor(mach[2]),
                              x.device)))
    return out


# ------------------------------------------------------------ the split --

def cluster_finish(k1_outs, sums, outputs, mach, clusters, *,
                   track_ab: bool):
    """K2's closed form per (output, machine, core): K1's 12 counters of
    the core's K1 output, then ``contention_stalls = mem_latency * Σ w·q``,
    ``l2_hits = Σ w·l2h``, ``l2_misses = Σ w·reqs``, and ``cycles`` plus
    ``mem_latency * Σ w·q + (l2_hit_cycles - mem_latency) * Σ w·l2h``;
    wrapping as int32.  ``sums`` is (K, MAX_CORES, NUM_SETS, 3).  Returns
    ``(ctr, ctr_a, ctr_b)``, (Q, M, MAX_CORES, 15) int32 each, zero past
    a lane's core count."""
    dev = sums.device
    lat = torch.as_tensor(mach[2], device=dev).to(torch.long)
    M = lat.shape[0]
    Q = len(outputs)
    out = torch.zeros((NUM_SETS, Q, M, MAX_CORES, CLUSTER_COUNTERS),
                      dtype=torch.long, device=dev)
    k1s = torch.stack([o.to(torch.long) for o in k1_outs])    # (3, Q1, M, 12)
    for o, (_, _, i, kl, q1s) in enumerate(outputs):
        n, hit = len(q1s), clusters[i][4]
        h, r, q = sums[kl, :n].to(torch.long).unbind(-1)       # (n, sets)
        e = k1s[:, q1s].transpose(1, 2)                         # (3, M, n, 12)
        stall = lat[None, :, None] * q.T[:, None, :]
        cyc = (e[..., CYCLES] + stall
               + (hit - lat)[None, :, None] * h.T[:, None, :])
        out[:, o, :, :n] = torch.cat([
            cyc[..., None], e[..., 1:], stall[..., None],
            h.T[:, None, :, None].expand_as(stall[..., None]),
            r.T[:, None, :, None].expand_as(stall[..., None])], dim=-1)
    out = _wrap32(out).to(torch.int32)
    if not track_ab:
        out[1:] = 0
    return tuple(out[s].contiguous() for s in range(NUM_SETS))


def cluster_l2_plain(x, keep, group, k1_outs, mach, clusters, *,
                     l1_sets: int, track_ab: bool = True, lengths=None):
    """K2 in plain torch, in the split: from K1b's plain accesses and
    outcomes (``keep``: ``lane, row, site, line, miss`` of
    ``engine_scan.engine_l1_plain(..., keep=True)``), for each K2 lane of
    ``group`` each core's L1 misses shifted by its shift, those at line
    >= 0 kept as requests and put in (row, rank, site) order; each L2 set
    walked on its own (``engine_scan._walk`` with a clock and no write,
    so LRU with first-index ties); per (row, rank) the hits and the
    requests that missed, the arbiter's queue rounds, and per core the
    sums times ``wt``/``wa``/``wb``; then :func:`cluster_finish`.  Returns
    what :func:`cluster_l2_cuda` returns."""
    del l1_sets
    dev = x.device
    miss = keep["miss"]
    m_lane, m_row, m_site, m_line = (keep[k][miss] for k in (
        "lane", "row", "site", "line"))
    # the misses are in engine order, lane by lane
    at = torch.searchsorted(m_lane, torch.arange(
        len(group["l1_lanes"]) + 1, device=dev)).tolist()
    K = len(group["k2_lanes"])
    sums = torch.zeros((K, MAX_CORES, NUM_SETS, K2_SUMS), dtype=torch.long,
                       device=dev)
    rows_of = [x.shape[1]] * x.shape[0] if lengths is None else list(lengths)
    for kl, (p, _, i, l1s, shifts) in enumerate(group["k2_lanes"]):
        n, sets, ways, chan, _ = clusters[i]
        T = int(rows_of[p])
        parts = []
        for c in range(n):
            sel = slice(at[l1s[c]], at[l1s[c] + 1])
            row, site = m_row[sel], m_site[sel]
            line = _wrap32(m_line[sel] + shifts[c])
            keep_c = line >= 0
            row, site, line = row[keep_c], site[keep_c], line[keep_c]
            rank = torch.remainder(c - row, n)
            parts.append(torch.stack([row, rank, site, line]))
        row, rank, site, line = torch.cat(parts, dim=1)
        order = torch.sort((row * n + rank) * SITES + site, stable=True)
        row, rank, line = (a[order.indices] for a in (row, rank, line))
        hit = torch.zeros_like(row, dtype=torch.bool)
        if sets and row.numel():
            bucket = torch.remainder(line, sets)
            by = torch.sort(bucket, stable=True).indices
            stamp = 2 * (torch.arange(row.numel(), device=dev) + 1)
            m, _ = k1._walk(bucket[by], line[by], torch.zeros_like(line),
                            stamp[by], sets, 1, ways)
            hit[by] = ~m
        cell = row * n + rank
        l2h = torch.zeros(T * n, dtype=torch.long, device=dev).index_add_(
            0, cell, hit.long()).view(T, n)
        reqs = torch.zeros(T * n, dtype=torch.long, device=dev).index_add_(
            0, cell, (~hit).long()).view(T, n)
        q = contention.queue_rounds(reqs, chan)
        w = x[p, :T, WT:WB + 1].to(torch.long)                  # (T, sets)
        core = torch.remainder(torch.arange(T, device=dev)[:, None]
                               + torch.arange(n, device=dev), n)  # (T, n)
        vals = torch.stack([l2h, reqs, q], dim=-1)                # (T, n, 3)
        sums[kl].index_add_(0, core.reshape(-1), (
            w[:, None, :, None] * vals[:, :, None, :]).reshape(
                T * n, NUM_SETS, K2_SUMS))
    sums = _wrap32(sums)
    if not track_ab:
        sums[:, :, 1:] = 0
    return cluster_finish(k1_outs, sums, group["k2_outputs"], mach,
                          clusters, track_ab=track_ab)


def _cluster_run(x, spill0s, strides, cfg, mach, clusters, *, l1_sets,
                 l1_ways, track_ab, lengths, reg_fn, l1_fn, k2_fn):
    """The cluster as the split: per launch group of
    :func:`cluster_scan_plan`, K1a (``reg_fn``) on its cVRF lanes, K1b
    (``l1_fn``, keeping its L1-miss stream) on its K1b lanes, then K2
    (``k2_fn``) for every cluster point at once; each output lands at its
    (program, config) in its cluster point's (P, C, M, N, 15) counters."""
    P, T, _ = x.shape
    dev = x.device
    host_cfg = tuple(np.asarray(torch.as_tensor(a).cpu()) for a in cfg)
    host_len = [T] * P if lengths is None else torch.as_tensor(
        lengths).cpu().tolist()
    host_strides = torch.as_tensor(strides).cpu().tolist()
    clusters = [_cluster(c) for c in clusters]
    nmax = max(c[0] for c in clusters)
    plan = cluster_scan_plan(
        l1_sets, l1_ways, host_len, host_cfg, clusters, strides=host_strides,
        invariant=address_invariant(x, spill0s, host_strides, host_len,
                                    nmax), T=T)
    C, M = len(host_cfg[0]), len(mach[0])
    outs = [[torch.zeros((P * C, M, c[0], CLUSTER_COUNTERS),
                         dtype=torch.int32, device=dev)
             for _ in range(NUM_SETS)] for c in clusters]
    kw = dict(track_ab=track_ab, lengths=host_len)
    for g in plan["groups"]:
        if g["reg_lanes"]:
            prog, k = zip(*g["reg_lanes"])
            stream, reg_ctr = reg_fn(x, list(prog), tuple(
                a[list(k)] for a in host_cfg), **kw)
        else:
            stream = torch.empty((0, T, REG_SITES), dtype=torch.int8,
                                 device=dev)
            reg_ctr = torch.zeros((0, NUM_SETS, len(REG_COUNTERS)),
                                  dtype=torch.int32, device=dev)
        l1_prog, _, l1_reg, l1_base = map(list, zip(*g["l1_lanes"]))
        k1_outs, keep = l1_fn(
            x, spill0s, stream, reg_ctr, l1_prog, l1_reg,
            [j for _, _, j in g["k1_outputs"]], mach, l1_sets=l1_sets,
            l1_ways=l1_ways, l1_base=l1_base, keep=True, **kw)
        res = k2_fn(x, keep, g, k1_outs, mach, clusters, l1_sets=l1_sets,
                    **kw)
        del keep
        for i, cl in enumerate(clusters):
            sel = [o for o, out in enumerate(g["k2_outputs"]) if out[2] == i]
            if not sel:
                continue
            at = torch.as_tensor([g["k2_outputs"][o][0] * C
                                  + g["k2_outputs"][o][1] for o in sel],
                                 device=dev)
            idx = torch.as_tensor(sel, device=dev)
            for s in range(NUM_SETS):
                outs[i][s][at] = res[s][idx, :, :cl[0]]
    return [tuple(o.view(P, C, M, c[0], CLUSTER_COUNTERS) for o in out)
            for c, out in zip(clusters, outs)]


def cluster_split_plain(x, spill0s, strides, cfg, mach, clusters, *,
                        l1_sets: int, l1_ways: int, track_ab: bool = True,
                        lengths=None):
    """The split in plain torch, as :func:`cluster_scan_cuda` runs it on the
    card (the same plan and groups): ``engine_reg_plain``,
    ``engine_l1_plain`` and :func:`cluster_l2_plain`.  Returns what
    :func:`cluster_scan_plain` returns."""
    return _cluster_run(
        x, spill0s, strides, cfg, mach, clusters, l1_sets=l1_sets,
        l1_ways=l1_ways, track_ab=track_ab, lengths=lengths,
        reg_fn=k1.engine_reg_plain, l1_fn=k1.engine_l1_plain,
        k2_fn=cluster_l2_plain)


# ------------------------------------------------------------ on the card --

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ARGTYPES = {
    "cluster_l2_launch": (
        [_P, _LL, _P]                                   # rows, T, lengths
        + [_I, _P, _P, _P, _P, _P, _I, _I]              # K1b's lanes, buffers
        + [_LL, _P]                                     # slots, misses
        + [_I] + [_P] * 8                               # K2 lanes
        + [_I, _I, _I, _LL, _P, _P, _P, _P, _P]         # S, ways, buffers
        + [_I, _I, _P, _P, _P, _P, _P, _P]              # outputs, K1's
        + [_P] * 4),                                    # out, stream
    "cluster_scan_tile": [_I, _I, _P],
}


@functools.cache
def _library():
    """The built library, loaded once, with every entry point's ctypes
    signature set."""
    from repro_torch.kernels import _build

    lib = _build.load("cluster_scan")
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def built_tile(l2_sets: int, l2_ways: int) -> dict:
    """The built kernel's tile for the largest L2 of a launch
    (``cluster_scan_tile``): the :data:`TILE_KEYS` figures that
    :func:`cluster_scan_plan` must state."""
    out = (ctypes.c_int * len(TILE_KEYS))()
    if _library().cluster_scan_tile(l2_sets, l2_ways, out):
        raise ValueError(f"cluster_scan does not take {l2_sets} sets x "
                         f"{l2_ways} ways")
    return dict(zip(TILE_KEYS, out))


def _padded(rows, fill):
    """Per-lane lists padded to MAX_CORES columns."""
    return [list(r) + [fill] * (MAX_CORES - len(r)) for r in rows]


@RouteCounted.over("l2set")
def cluster_l2_cuda(x, keep, group, k1_outs, mach, clusters, *,
                    l1_sets: int, track_ab: bool = True, lengths=None,
                    stats: dict | None = None):
    """Launch K2 on a CUDA tensor ``x`` for the K2 lanes of a launch
    ``group`` of :func:`cluster_scan_plan`, from K1b's kept buffers
    (``keep``: ``engine_scan.engine_l1_cuda(..., keep=True)``) and K1's
    counters ``k1_outs``: returns ``(ctr, ctr_a, ctr_b)``, (Q, M,
    MAX_CORES, 15) int32 each (zero past a lane's core count).  ``stats``
    gets the launch's bucketed requests and its largest (lane, L2 set)
    bucket, K2's longest chain (a synchronisation).  Raises on what the
    kernel does not take and on a failed launch; never falls back."""
    x = _rows_on_card(x, "cluster_l2_cuda")
    P, T, _ = x.shape
    dev = x.device
    clusters = [_cluster(c) for c in clusters]
    host_len = [T] * P if lengths is None else torch.as_tensor(
        lengths).cpu().tolist()
    lanes = group["k2_lanes"]
    outputs = group["k2_outputs"]
    K, Q, L = len(lanes), len(outputs), len(group["l1_lanes"])
    S = max(1, max(c[1] for c in clusters))
    ways = max((c[2] for c in clusters if c[1]), default=1)
    mach = [_int32_on(a, dev, n) for a, n in zip(
        mach, ("l1_hit_cycles", "uop_hit_cycles", "mem_latency"))]
    M = mach[0].shape[0]
    Q1 = len(group["k1_outputs"])
    if K == 0 or Q == 0 or any(tuple(o.shape) != (Q1, M, NUM_COUNTERS)
                               for o in k1_outs):
        raise ValueError(f"cluster_l2_cuda: a group needs K2 lanes and "
                         f"outputs, and K1's counters ({Q1}, {M}, "
                         f"{NUM_COUNTERS})")
    tiles2 = max(1, -(-T // K2_TILE_ROWS))
    i32 = dict(dtype=torch.int32, device=dev)
    k_prog = [p for p, *_ in lanes]
    cl = [clusters[i] for _, _, i, _, _ in lanes]
    arrays = dict(
        l1_reg=[r for _, _, r, _ in group["l1_lanes"]],
        l1_slot0=keep["slots"],
        k_prog=k_prog, k_cores=[c[0] for c in cl], k_sets=[c[1] for c in cl],
        k_ways=[c[2] for c in cl], k_chan=[c[3] for c in cl],
        k_hit=[c[4] for c in cl],
        k_l1=_padded([l1s for *_, l1s, _ in lanes], 0),
        k_shift=_padded([sh for *_, sh in lanes], 0),
        o_lane=[kl for _, _, _, kl, _ in outputs],
        o_k1=_padded([q1s for *_, q1s in outputs], 0))
    dv = {name: _int32_on(v, dev, name) for name, v in arrays.items()}
    slots = keep["slots"][-1]
    requests = sum(c[0] * host_len[p] * (SITES if group["l1_lanes"][l1s[0]][
        2] >= 0 else 2) for (p, _, _, l1s, _), c in zip(lanes, cl))
    n = K * S * tiles2
    lengths_d = _int32_on(host_len, dev, "lengths")
    misses = torch.empty(max(slots, 1), **i32)
    hist = torch.empty(n + 1, **i32)
    blocks = torch.empty(max(1, -(-n // 1024)), **i32)
    req = torch.empty((max(requests, 1), 2), **i32)
    counts = torch.empty((K, T), dtype=torch.int64, device=dev)
    sums = torch.empty((K, MAX_CORES, NUM_SETS, K2_SUMS), **i32)
    outs = [torch.zeros((Q, M, MAX_CORES, CLUSTER_COUNTERS), **i32)
            for _ in range(NUM_SETS)]
    k1c = [o.contiguous() for o in k1_outs]
    _launch(x, "cluster_l2_launch", x.data_ptr(), T, lengths_d.data_ptr(),
            L, *_ptrs(dv["l1_reg"], dv["l1_slot0"], keep["recs"],
                      keep["outcome"], keep["hist"]), l1_sets, keep["tiles"],
            slots, misses.data_ptr(),
            K, *_ptrs(*(dv[k] for k in ("k_prog", "k_cores", "k_sets",
                                        "k_ways", "k_chan", "k_hit", "k_l1",
                                        "k_shift"))),
            S, ways, int(bool(track_ab)), requests,
            *_ptrs(hist, blocks, req, counts, sums),
            Q, M, *_ptrs(dv["o_lane"], dv["o_k1"], mach[2], *k1c), *_ptrs(
                *outs), library=_library)
    cluster_l2_cuda.count(dict(route="l2set"))
    if stats is not None:
        starts = hist[0:n:tiles2].to(torch.long)
        sizes = torch.diff(torch.cat([starts, hist[n:].to(torch.long)]))
        stats.update(bucketed_requests=int(hist[n]),
                     largest_bucket=int(sizes.max()))
    return tuple(outs)


def cluster_scan_cuda(x, spill0s, strides, cfg, mach, clusters, *,
                      l1_sets: int, l1_ways: int, track_ab: bool = True,
                      lengths=None):
    """The cluster on a CUDA tensor ``x`` (P, T, NCOL) int32, the other
    inputs moved to x's card: :func:`cluster_scan_plan`'s groups, each
    K1a (``engine_reg_cuda``, where a config has capacity < 32), K1b
    (``engine_l1_cuda``, its buffers kept) and K2
    (:func:`cluster_l2_cuda`).  Returns what :func:`cluster_scan_plain`
    returns.  Raises on what the kernels do not take and on a failed
    launch; never falls back."""
    x = _rows_on_card(x, "cluster_scan_cuda")
    P, T, _ = x.shape
    dev = x.device
    lengths = _int32_on([T] * P if lengths is None else lengths, "cpu",
                        "lengths")
    strides = _int32_on(strides, "cpu", "strides")
    if lengths.shape != (P,) or strides.shape != (P,):
        raise ValueError("cluster_scan_cuda: lengths and strides must be "
                         "(P,)")
    if int(lengths.min()) < 0 or int(lengths.max()) > T:
        raise ValueError(f"cluster_scan_cuda: lengths must lie in [0, {T}]")
    return _cluster_run(
        x, _int32_on(spill0s, dev, "spill0s"), strides.tolist(), cfg, mach,
        clusters, l1_sets=l1_sets, l1_ways=l1_ways, track_ab=track_ab,
        lengths=lengths.tolist(), reg_fn=k1.engine_reg_cuda,
        l1_fn=k1.engine_l1_cuda, k2_fn=cluster_l2_cuda)


def cluster_scan(x, spill0s, strides, cfg, mach, clusters, *, l1_sets: int,
                 l1_ways: int, track_ab: bool = True, lengths=None):
    """One ``(ctr, ctr_a, ctr_b)`` per cluster point, (P, C, M, N, 15)
    int32 each, over ``x`` (P, T, NCOL) int32: the twin for a CPU x, K1
    and K2 for a CUDA x."""
    kw = dict(l1_sets=l1_sets, l1_ways=l1_ways, track_ab=track_ab,
              lengths=lengths)
    if x.is_cpu:
        return cluster_scan_plain(x, spill0s, strides, cfg, mach, clusters,
                                  **kw)
    if x.is_cuda:
        return cluster_scan_cuda(x, spill0s, strides, cfg, mach, clusters,
                                 **kw)
    raise ValueError(f"cluster_scan runs on cpu or cuda, not {x.device}")
