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

K2 on the card, one launch whose work and buffers scale with the L1
misses and not with rows x cores x sites: K1b's misses compacted per K1b
lane in (row, site) order (a missed-site mask and a count per row, an
exclusive scan, a scatter); each K2 lane's candidates (its cores' misses
in the reference's (row, rank, site) order, numbered on the card) counted
per (lane, L2 set, tile of candidates) by a warp, an exclusive scan, the
same warps scatter each request to its (lane, L2 set) bucket; one thread
per bucket walks it through the set's ways with a local clock (the L2
decides from the order within a set only) and marks each hit; per (lane,
row with a miss) the arbiter's exclusive scan over ranks and
``// mem_channels``, summed per core times ``wt``/``wa``/``wb``; the
closed form per (output, machine, core) adds K1's counters.

Plain versions: :func:`cluster_scan_plain`, the twin, a separate
formulation of the reference's lockstep step (K1's one-walk twin with N
core lanes, each walking its own L1, and the L2 probed per site with
``contention.l2_access``): it assumes no shift invariance, and it is the
CPU path.  :func:`cluster_l2_plain`, K2's counterpart in the split: it
takes K1b's plain accesses and outcomes (``engine_scan.l1_accesses``,
``l1_outcomes``), expands them to N cores and walks by L2 set; composed
with K1's plain halves it is :func:`cluster_split_plain`, K2's oracle on
the card.  :func:`miss_stream_plain` and :func:`request_buckets_plain` are
the plain versions of K2's compacted miss stream and its request buckets,
which :func:`cluster_l2_plain` walks and on which the card's buffers are
held (``cluster_l2_cuda(..., buffers=...)``).
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
# The kernel's tiles (csrc/cluster_scan.cu): candidates a bucketing warp
# takes, bucketing warps a CTA (each with a shared counter per L2 set),
# walkers a CTA, CTAs of the bucket offsets' scan at most
K2_TILE_CANDIDATES = 512
K2_HIST_WARPS = 4
K2_WALK_THREADS = 128
K2_SCAN_CTAS = 1024
TILE_KEYS = ("tile_candidates", "hist_warps_per_cta", "hist_smem_bytes",
             "way_slots", "walk_threads", "max_cores")
# Bytes a candidate takes (its bucketed request: line and candidate, and
# its state byte), a compacted miss (line and row << 3 | site, and its
# place byte) and a (K1b lane, row) (its missed-site mask and offset)
CANDIDATE_BYTES = 9
MISS_BYTES = 9
ROW_BYTES = 5


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

    the bytes of its buffers, K2's bounded by the access slots (a
    lane's candidates, its cores' L1 misses, are at most cores x rows x
    sites), and ``k2_table``, what K2's launch takes from the host
    (:func:`_k2_table`).  Raises ``ValueError`` for what the
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
    tile = dict(tile_candidates=K2_TILE_CANDIDATES,
                hist_warps_per_cta=K2_HIST_WARPS,
                hist_smem_bytes=hist_smem,
                way_slots=1 << (ways - 1).bit_length(),
                walk_threads=K2_WALK_THREADS, max_cores=MAX_CORES)
    nmax = max(c[0] for c in clusters)
    classes = k1.cvrf_classes(*cfg)
    kinds = list(dict.fromkeys(classes))
    tiles1 = k1._tiles(T)
    groups, group = [], None
    for p, rows in enumerate(lengths):
        cores1 = 1 if invariant[p] else nmax
        need = dict.fromkeys(("stream", "records", "hist", "misses", "rows",
                              "requests", "l2_hist"), 0)
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
            need["misses"] += cores1 * rows * nsites * MISS_BYTES
            need["rows"] += cores1 * rows * ROW_BYTES
            outs = {}
            for c, kc in enumerate(classes):
                if kc == k:
                    outs[c] = []
                    for j in lanes:
                        outs[c].append(len(fam["k1_outputs"]))
                        fam["k1_outputs"].append((p, c, j))
            for i, (n, sets, *_rest) in enumerate(clusters):
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
                cands = n * rows * nsites
                need["requests"] += cands * CANDIDATE_BYTES
                need["l2_hist"] += sets * -(-cands // K2_TILE_CANDIDATES) * 4
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
        if g["bytes"]["requests"] >= 2 ** 31 * CANDIDATE_BYTES:
            raise ValueError("cluster_scan takes fewer than 2^31 candidate "
                             "requests a launch group")
        g["k2_table"] = _k2_table(g, clusters, lengths)
    return dict(route="l2set", tile=tile, classes=classes, l2_sets=S,
                groups=groups, budget_bytes=k1.STREAM_BUDGET_BYTES)


def _k2_table(group, clusters, lengths) -> dict:
    """What K2's launch for ``group`` takes from the host, built once with
    the plan: ``flat``, one int32 array of the programs' lengths, each K1b
    lane's first row slot (L + 1: its program's rows summed over the
    lanes before it), the K2 lanes' program, cores, L2 sets, ways,
    channels and hit cycles (K each), each lane's cores' K1b lanes and
    shifts ((K, MAX_CORES) each), each output's lane (Q) and its cores'
    K1 outputs ((Q, MAX_CORES)), with ``at``, each array's offset; and
    the bounds the buffers are sized by: ``row_slots``, ``candidates``
    (cores x rows x sites a lane, summed), ``tiles`` (of
    :data:`K2_TILE_CANDIDATES` candidates) and ``hist_entries`` ((set,
    tile) pairs).  :func:`cluster_l2_cuda` keeps its card copies under
    ``on``."""
    lanes, outputs, l1 = (group[k] for k in ("k2_lanes", "k2_outputs",
                                             "l1_lanes"))
    K = len(lanes)
    cl = [clusters[i] for _, _, i, _, _ in lanes]
    row0 = np.cumsum([0] + [lengths[p] for p, *_ in l1])
    cands = [c[0] * lengths[p] * (SITES if l1[l1s[0]][2] >= 0 else 2)
             for (p, _, _, l1s, _), c in zip(lanes, cl)]
    tiles = [-(-n // K2_TILE_CANDIDATES) for n in cands]
    lane_tab = np.array([[v[0], *c, *l1s, *sh] for v, c, l1s, sh in zip(
        lanes, cl, _padded([v[3] for v in lanes], 0),
        _padded([v[4] for v in lanes], 0))], np.int64).reshape(K, -1)
    out_tab = np.array([[o[3], *q1s] for o, q1s in zip(
        outputs, _padded([o[4] for o in outputs], 0))],
        np.int64).reshape(len(outputs), -1)
    parts = [np.asarray(lengths, np.int64), row0, lane_tab[:, :6].T,
             lane_tab[:, 6:].reshape(K, 2, MAX_CORES).transpose(1, 0, 2),
             out_tab[:, 0], out_tab[:, 1:]]
    flat = np.concatenate([v.ravel() for v in parts])
    if flat.size and (flat.min() < -2 ** 31 or flat.max() >= 2 ** 31):
        raise ValueError("cluster_scan: a K2 lane array exceeds int32")
    return dict(flat=flat.astype(np.int32),
                at=np.cumsum([0] + [v.size for v in parts]).tolist(),
                row_slots=int(row0[-1]), candidates=sum(cands),
                tiles=sum(tiles),
                hist_entries=sum(c[1] * t for c, t in zip(cl, tiles)))


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


def miss_stream_plain(keep, group, lengths) -> dict:
    """K2's compacted L1-miss stream in plain torch: each K1b lane of
    ``group``'s L1 misses (from ``keep``, the ``lane, row, site, line,
    miss`` of ``engine_scan.engine_l1_plain(..., keep=True)``, in engine
    order) in (lane, row, site) order.  Each lane owns the row slots
    ``row0[j]:row0[j + 1]`` (its program's rows, ``lengths[p]``).
    Returns ``row0`` (L + 1) and, as int64 tensors, ``row_off`` (row
    slots + 1: the misses before each slot), ``row_mask`` (per slot, bit
    s for a miss at site s) and per miss its ``line``, ``row``, ``site``,
    ``place`` in its row and its row's misses ``row_misses``."""
    dev = keep["line"].device
    row0 = np.cumsum([0] + [int(lengths[p]) for p, *_ in
                            group["l1_lanes"]]).tolist()
    miss = keep["miss"]
    lane, row, site, line = (keep[k][miss] for k in ("lane", "row", "site",
                                                     "line"))
    cell = torch.as_tensor(row0[:-1], dtype=torch.long, device=dev)[
        lane] + row
    counts = torch.bincount(cell, minlength=row0[-1])
    row_off = torch.zeros(row0[-1] + 1, dtype=torch.long, device=dev)
    row_off[1:] = torch.cumsum(counts, 0)
    row_mask = torch.zeros(row0[-1], dtype=torch.long, device=dev)
    row_mask.index_add_(0, cell, torch.bitwise_left_shift(
        torch.ones_like(site), site))
    return dict(row0=row0, row_off=row_off, row_mask=row_mask, line=line,
                row=row, site=site,
                place=torch.arange(cell.numel(), device=dev) - row_off[cell],
                row_misses=counts[cell])


def request_buckets_plain(stream, group, clusters) -> dict:
    """K2's candidates and request buckets in plain torch, from
    :func:`miss_stream_plain`'s ``stream``: per K2 lane of ``group``
    (lanes in order, candidate indices counted across them from
    ``cand_base``), its candidates, each core's misses shifted by its
    shift in the reference's (row, rank, site) order (rank r of row t is
    core (t mod N + r) mod N); those at line >= 0 are requests, put
    stably by L2 set (``line mod sets``) into the lane's buckets, which
    follow each other lane by lane and set by set.  Returns
    ``cand_base`` (K + 1), per candidate ``row``, ``rank``, ``line`` (the
    shifted line) and ``on`` (a request), per bucketed request ``req_line``
    and ``req_cand`` (its candidate), and ``bucket_start``: per lane its
    sets + 1 bucket offsets into the requests (an empty tensor for a
    lane without an L2)."""
    dev = stream["row_off"].device
    row0, row_off = stream["row0"], stream["row_off"]
    rows, ranks, lines, bases = [], [], [], [0]
    req_line, req_cand, starts = [], [], []
    nreq = 0
    for p, _, i, l1s, shifts in group["k2_lanes"]:
        n, sets = clusters[i][0], clusters[i][1]
        parts = []
        for c in range(n):
            a, b = (int(row_off[row0[j]]) for j in (l1s[c], l1s[c] + 1))
            row = stream["row"][a:b]
            parts.append(torch.stack([
                row, torch.remainder(c - row, n), stream["site"][a:b],
                _wrap32(stream["line"][a:b] + shifts[c])]))
        row, rank, site, line = torch.cat(parts, dim=1)
        order = torch.sort((row * n + rank) * SITES + site,
                           stable=True).indices
        row, rank, line = (v[order] for v in (row, rank, line))
        rows.append(row)
        ranks.append(rank)
        lines.append(line)
        on = torch.nonzero(line >= 0).flatten()
        if sets:
            s = torch.remainder(line[on], sets)
            by = torch.sort(s, stable=True).indices
            req_line.append(line[on[by]])
            req_cand.append(bases[-1] + on[by])
            starts.append(nreq + torch.searchsorted(
                s[by], torch.arange(sets + 1, device=dev)))
            nreq += on.numel()
        else:
            starts.append(torch.empty(0, dtype=torch.long, device=dev))
        bases.append(bases[-1] + row.numel())
    empty = torch.empty(0, dtype=torch.long, device=dev)
    line = torch.cat(lines) if lines else empty
    return dict(cand_base=bases, row=torch.cat(rows) if rows else empty,
                rank=torch.cat(ranks) if ranks else empty, line=line,
                on=line >= 0,
                req_line=torch.cat(req_line) if req_line else empty,
                req_cand=torch.cat(req_cand) if req_cand else empty,
                bucket_start=starts)


def cluster_l2_plain(x, keep, group, k1_outs, mach, clusters, *,
                     l1_sets: int, track_ab: bool = True, lengths=None):
    """K2 in plain torch, in the split: from K1b's plain accesses and
    outcomes (``keep``: ``lane, row, site, line, miss`` of
    ``engine_scan.engine_l1_plain(..., keep=True)``), the compacted miss
    stream (:func:`miss_stream_plain`) and each K2 lane's candidates and
    request buckets (:func:`request_buckets_plain`); each (lane, L2 set)
    bucket walked on its own (``engine_scan._walk`` with a clock and no
    write, so LRU with first-index ties); per (row, rank) the hits and
    the requests that missed, the arbiter's queue rounds, and per core
    the sums times ``wt``/``wa``/``wb``; then :func:`cluster_finish`.
    Returns what :func:`cluster_l2_cuda` returns."""
    del l1_sets
    dev = x.device
    rows_of = [x.shape[1]] * x.shape[0] if lengths is None else list(lengths)
    cand = request_buckets_plain(miss_stream_plain(keep, group, rows_of),
                                 group, clusters)
    hit = torch.zeros_like(cand["on"])
    K = len(group["k2_lanes"])
    sums = torch.zeros((K, MAX_CORES, NUM_SETS, K2_SUMS), dtype=torch.long,
                       device=dev)
    for kl, (p, _, i, _, _) in enumerate(group["k2_lanes"]):
        n, sets, ways, chan, _ = clusters[i]
        T = int(rows_of[p])
        if sets:
            st = cand["bucket_start"][kl]
            lo, hi = int(st[0]), int(st[-1])
            bucket = torch.repeat_interleave(
                torch.arange(sets, device=dev), torch.diff(st))
            line = cand["req_line"][lo:hi]
            m, _ = k1._walk(bucket, line, torch.zeros_like(line),
                            2 * torch.arange(1, hi - lo + 1, device=dev),
                            sets, 1, ways)
            hit[cand["req_cand"][lo:hi][~m]] = True
        at = slice(cand["cand_base"][kl], cand["cand_base"][kl + 1])
        cell = cand["row"][at] * n + cand["rank"][at]
        l2h = torch.zeros(T * n, dtype=torch.long, device=dev).index_add_(
            0, cell, hit[at].long()).view(T, n)
        reqs = torch.zeros(T * n, dtype=torch.long, device=dev).index_add_(
            0, cell, (cand["on"][at] & ~hit[at]).long()).view(T, n)
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
        + [_I, _P, _P, _P, _P, _LL, _LL, _LL]           # K1b's lanes, buffers
        + [_I] + [_P] * 8                               # K2 lanes
        + [_I, _I, _I, _LL, _LL, _LL]                   # S, ways, bounds
        + [_P] * 10                                     # scratch
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


def _carve(sizes, dtype, dev, align: int) -> list:
    """Slices of one new tensor, one per size, each starting at a
    multiple of ``align`` elements."""
    starts, at = [], 0
    for n in sizes:
        starts.append(at)
        at += -(-n // align) * align
    buf = torch.empty(max(at, 1), dtype=dtype, device=dev)
    return [buf[a:a + n] for a, n in zip(starts, sizes)]


def _k2_table_on(tab, mem, dev):
    """A plan's ``k2_table`` with the machines' memory latencies ``mem``
    appended, on ``dev``: one copy that does not wait for the card, made
    the first time a (device, ``mem``) pair is asked for and kept in the
    table, so that a launch again with the same plan and machines issues
    no copy."""
    key = (str(dev), mem.tobytes())
    cache = tab.setdefault("on", {})
    if key not in cache:
        host = torch.from_numpy(np.concatenate([tab["flat"], mem]))
        cache[key] = host.pin_memory().to(dev, non_blocking=True) if (
            dev.type == "cuda") else host
    return cache[key]


@RouteCounted.over("l2set")
def cluster_l2_cuda(x, keep, group, k1_outs, mach, clusters, *,
                    l1_sets: int, track_ab: bool = True, lengths=None,
                    stats: dict | None = None, buffers: dict | None = None):
    """Launch K2 on a CUDA tensor ``x`` for the K2 lanes of a launch
    ``group`` of :func:`cluster_scan_plan`, from K1b's kept buffers
    (``keep``: ``engine_scan.engine_l1_cuda(..., keep=True)``) and K1's
    counters ``k1_outs``: returns ``(ctr, ctr_a, ctr_b)``, (Q, M,
    MAX_CORES, 15) int32 each (zero past a lane's core count).  The
    lanes' arrays cross in one copy that does not wait for the card.
    ``stats`` gets the launch's compacted misses, candidates, bucketed
    requests and its largest (lane, L2 set) bucket, K2's longest chain (a
    synchronisation); ``buffers`` gets K2's own buffers, trimmed to what
    the launch wrote (a synchronisation): the compacted stream
    (``row_off``, ``miss_line``, ``miss_row``, ``miss_site``), ``cand_base``
    and the buckets (``req_line``, ``req_cand``, ``bucket_start`` per
    lane), as :func:`miss_stream_plain` and :func:`request_buckets_plain`
    give them.  The lanes' arrays and the programs' lengths come from
    the group's ``k2_table`` (``lengths``, where given, must be those).
    Raises on what the kernel does not take and on a failed launch; never
    falls back."""
    x = _rows_on_card(x, "cluster_l2_cuda")
    T = x.shape[1]
    dev = x.device
    clusters = [_cluster(c) for c in clusters]
    lanes = group["k2_lanes"]
    outputs = group["k2_outputs"]
    l1_lanes = group["l1_lanes"]
    K, Q, L = len(lanes), len(outputs), len(l1_lanes)
    S = max(1, max(c[1] for c in clusters))
    ways = max((c[2] for c in clusters if c[1]), default=1)
    M = len(mach[0])
    Q1 = len(group["k1_outputs"])
    if K == 0 or Q == 0 or any(tuple(o.shape) != (Q1, M, NUM_COUNTERS)
                               for o in k1_outs):
        raise ValueError(f"cluster_l2_cuda: a group needs K2 lanes and "
                         f"outputs, and K1's counters ({Q1}, {M}, "
                         f"{NUM_COUNTERS})")
    tab = group["k2_table"]
    if lengths is not None and [int(n) for n in lengths] != tab["flat"][
            :tab["at"][1]].tolist():
        raise ValueError("cluster_l2_cuda: lengths differ from the plan's")
    mem = _int32_on(mach[2], "cpu", "mem_latency").numpy()
    if mem.shape != (M,):
        raise ValueError(f"cluster_l2_cuda: mem_latency must be ({M},)")
    plan = _k2_table_on(tab, mem, dev)
    ptr = [plan.data_ptr() + 4 * a for a in tab["at"]]    # mem at the end
    k_ptrs = [ptr[2] + 4 * K * i for i in range(6)] + [
        ptr[3], ptr[3] + 4 * K * MAX_CORES]
    records = keep["slots"][-1]
    R, C = tab["row_slots"], tab["candidates"]
    hist_entries = tab["hist_entries"]
    row_off, miss, meta, hist, blocks, req, sums = _carve(
        [max(R, 1) + 1, 2 * max(records, 1), 3 * (K + 1) + 1,
         hist_entries + 1, max(-(-R // k1.SCAN_BLOCK), K2_SCAN_CTAS + 1),
         2 * max(C, 1), K * MAX_CORES * NUM_SETS * K2_SUMS],
        torch.int32, dev, 64)
    row_mask, miss_pm, state = _carve(
        [max(4, -(-R // 4) * 4), max(records, 1), max(C, 1)], torch.uint8,
        dev, 256)
    outs = torch.empty((NUM_SETS, Q, M, MAX_CORES, CLUSTER_COUNTERS),
                       dtype=torch.int32, device=dev).unbind(0)
    k1c = [o.contiguous() for o in k1_outs]
    _launch(x, "cluster_l2_launch", x.data_ptr(), T, ptr[0], L, ptr[1],
            *_ptrs(keep["recs"], keep["outcome"], keep["hist"]),
            l1_sets * keep["tiles"], records, R, K, *k_ptrs,
            S, ways, int(bool(track_ab)), C, tab["tiles"], hist_entries,
            *_ptrs(row_mask, row_off, miss, miss_pm, meta, hist, blocks, req,
                   state, sums),
            Q, M, ptr[4], ptr[5], ptr[-1], *_ptrs(*k1c, *outs),
            library=_library)
    cluster_l2_cuda.count(dict(route="l2set"))
    if stats is not None or buffers is not None:
        base = meta[:3 * (K + 1)].view(3, K + 1).to(torch.long).cpu()
        starts = []
        for k, (_, _, i, _, _) in enumerate(lanes):
            c = clusters[i]
            t = int(base[1, k + 1] - base[1, k])
            starts.append(hist[int(base[2, k]) + t * torch.arange(
                c[1] + 1 if c[1] else 0, device=dev)].to(torch.long))
        nreq = int(hist[int(base[2, K])])
        nmiss = int(row_off[R])
    if stats is not None:
        sizes = [torch.diff(st) for st in starts if st.numel()]
        stats.update(
            compacted_misses=nmiss, candidates=int(base[0, K]),
            bucketed_requests=nreq,
            largest_bucket=int(torch.cat(sizes).max()) if sizes else 0)
    if buffers is not None:
        m = miss[:2 * nmiss].view(-1, 2).to(torch.long)
        buffers.update(
            row_off=row_off[:R + 1].to(torch.long), miss_line=m[:, 0],
            miss_row=m[:, 1] >> 3, miss_site=m[:, 1] & 7,
            cand_base=base[0].tolist(),
            req_line=req[0:2 * nreq:2].to(torch.long),
            req_cand=req[1:2 * nreq:2].to(torch.long), bucket_start=starts)
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
