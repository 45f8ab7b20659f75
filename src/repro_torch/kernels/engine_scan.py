"""The engine scan (K1): two CUDA kernels, their wrappers and plain twins.

Port of the reference's cycle engine, ``repro/core/simulator.py``
``_run_grid`` (a ``lax.scan`` of ``_make_step``/``_make_body`` under three
``vmap``s, with ``_l1_access`` and the policies of ``core/policies.py``).
XLA compiles it from a scan body, so it has no ``pallas_call``; on Hopper
it is hand-written, ``csrc/engine_scan.cu``, split in two along what the
reference's body lets apart:

* the cVRF never reads what the L1 returns, so **K1a**, the cVRF pass,
  walks each (program, cVRF class) lane's rows once, for every machine
  and L1 at once: one warp per lane with capacity < 32, slot i on thread
  i.  It writes the lane's spill and fill accesses (:data:`REG_SITES` a
  row) and its REG counters.  A full VRF (capacity >= 32) never misses,
  so its lanes launch nothing: their REG counters are sums over the
  trace;
* hits and misses do not depend on the latencies, and an access touches
  one set only, so **K1b**, the L1 pass, buckets each lane's accesses by
  set (a stable counting sort) and walks each bucket on its own thread,
  once for all machine points; a closed form per machine then gives the
  cycles.

Inputs: the 15 event arrays of ``simulator._stack`` packed by :func:`pack`
into one (P, T, ``NCOL``) int32 tensor (columns in :data:`COLUMNS`
order), the per-program spill bases and row counts, the config axis
(capacity, policy, alloc_no_fetch; (C,) each) and the machine axis (L1
hit, uop hit, memory latency; (M,) each), with the static L1 geometry.
Output: the (P, C, M, 12) int32 counters (order
``simulator.COUNTER_NAMES``) weighted by ``wt``, and the measured periods
A and B weighted by ``wa``/``wb`` (zeros unless ``track_ab``).

A CPU tensor goes to :func:`engine_scan_plain`, the one-walk oracle, a
CUDA tensor to :func:`engine_scan_cuda`, which plans the split
(:func:`engine_scan_plan`) and launches K1a (:func:`engine_reg_cuda`) and
K1b (:func:`engine_l1_cuda`) or raises; there is no fallback.  Each of
the two wrappers counts its launches.  :func:`engine_reg_plain`,
:func:`engine_l1_plain` and their composition :func:`engine_split_plain`
are the split's plain versions.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import policies
from repro_torch.core.isa import NUM_ARCH_VREGS
from repro_torch.kernels.routes import RouteCounted

# The packed row: (name, width) per event array of simulator._stack, in
# its order; a (T,) array is one column, a (T, k) array k columns.
COLUMNS = (("reg_valid", 3), ("reg", 3), ("vd_writes", 1), ("vd_reads", 1),
           ("vd_no_fetch", 1), ("lock_vs1", 1), ("lock_vs2", 1),
           ("mem_valid", 2), ("mem_line", 2), ("mem_write", 2), ("cost", 1),
           ("next_use", 3), ("weight", 1), ("wa", 1), ("wb", 1))
_OFFSET = dict(zip((name for name, _ in COLUMNS),
                   np.cumsum([0] + [w for _, w in COLUMNS])[:-1].tolist()))
NCOL = sum(w for _, w in COLUMNS)
(RV, REG, VDW, VDR, VDNF, LK1, LK2, MV, ML, MW, COST, NXT, WT, WA,
 WB) = (_OFFSET[name] for name, _ in COLUMNS)

# simulator.COUNTER_NAMES, in order
(CYCLES, STALL, HITS, MISSES, SPILLS, FILLS, L1_HITS, L1_MISSES, REG_READS,
 REG_WRITES, MEM_READS, MEM_WRITES) = range(12)
NUM_COUNTERS = 12
NOW_STEP = 6              # events.NUM_SLOTS: `now` advances per row

# The split.  A row's L1 access sites in engine order: spill then fill of
# REG slots 0..2 (K1a's stream: the register, or -1 where the site is
# inactive), then MEM lanes 0 and 1.
REG_SITES = 6
SITES = 8
NUM_SETS = 3              # counter sets: total (wt), period A (wa), B (wb)
# K1a's counters per lane and counter set
REG_COUNTERS = (HITS, MISSES, SPILLS, FILLS, REG_READS, REG_WRITES)
# K1b's sums per L1 lane and counter set: for the uop class (spill, fill)
# then the data class (MEM), the weighted accesses, misses, write-backs
L1_SUMS = 6
# The trace's sums per program and counter set: cost, REG accesses, REG
# reads, REG writes, MEM reads, MEM writes
TRACE_SUMS = 6

# The kernels' tiles (csrc/engine_scan.cu).  K1a: lanes (warps) a CTA,
# rows a warp stages in shared memory at a time.  K1b: rows of one lane a
# warp buckets, bucketing warps a CTA (each with a shared counter per
# set), entries a CTA of the offsets' scan takes, walkers a CTA.
REG_WARPS_PER_CTA = 4
CHUNK_ROWS = 32
TILE_ROWS = 1024
HIST_WARPS_PER_CTA = 4
SCAN_BLOCK = 1024
WALK_THREADS = 128
MAX_SMEM_BYTES = 232448
# A bucketed access packs its row as row << 4 | site << 1 | write
MAX_ROWS = 1 << 27
# Bytes of K1a's stream and K1b's buckets one launch pair may take; lanes
# are taken in groups under it (a lane alone may exceed it)
STREAM_BUDGET_BYTES = 2 << 30
# Bytes a bucketed access slot takes: the (line, packed row) record and
# the walk's outcome byte
RECORD_BYTES = 9


def pack(arrays, device="cpu") -> torch.Tensor:
    """``simulator._stack``'s 15 arrays, (P, T) or (P, T, k) each, as one
    (P, T, NCOL) int32 tensor on ``device``.  Each array crosses to the
    device at its own type and is widened there."""
    if len(arrays) != len(COLUMNS):
        raise ValueError(f"pack takes {len(COLUMNS)} arrays, got "
                         f"{len(arrays)}")
    cols = []
    for (name, width), a in zip(COLUMNS, arrays):
        t = torch.as_tensor(np.ascontiguousarray(a)) if isinstance(
            a, np.ndarray) else a
        t = t.to(device).to(torch.int32)
        t = t if t.dim() == 3 else t[..., None]
        if t.shape[-1] != width:
            raise ValueError(f"{name}: {width} columns expected, got shape "
                             f"{tuple(t.shape)}")
        cols.append(t)
    return torch.cat(cols, dim=2).contiguous()


def _i32(v: int) -> int:
    """A Python int wrapped to int32, as the reference's int32 carry."""
    return (v + 2**31) % 2**32 - 2**31


def l1_init(lanes: int, l1_sets: int, l1_ways: int, device="cpu"):
    """Per-lane L1 state: (tags, words), (lanes, sets, ways) int32 each;
    a tag is a line (-1 free), a word ``age << 1 | dirty``.  Age dominates
    the word, so the LRU argmin over it is the argmin over the raw age.
    (The reference packs the two as the last axis of one array.)"""
    shape = (lanes, l1_sets, l1_ways)
    return (torch.full(shape, -1, dtype=torch.int32, device=device),
            torch.zeros(shape, dtype=torch.int32, device=device))


@functools.cache
def _l1_offsets(lanes: int, l1_sets: int, l1_ways: int, device):
    """Flat offsets into an l1_init array: each lane's first entry, and
    each way's within a set."""
    return (torch.arange(lanes, device=device) * (l1_sets * l1_ways),
            torch.arange(l1_ways, device=device))


def l1_access(l1, line, is_write, now: int, active, hit_cost, mem_latency):
    """One cacheline access per lane, LRU within the set, write-allocate +
    write-back: the reference's ``_l1_access``.  Updates ``l1`` in place
    where ``active``; returns the (lanes,) cycles (0 where inactive) and
    hit flags.  The set is ``line`` floor-modulo the set count, as
    Python's ``%``: an inactive MEM lane's line -1 maps to the last set.
    A hit takes the first matching way, a miss the first least word (a
    free way holds 0)."""
    tags, words = l1
    lanes, sets, ways = tags.shape
    tags, words = tags.view(-1), words.view(-1)
    lane_off, way_off = _l1_offsets(lanes, sets, ways, tags.device)
    base = lane_off + torch.remainder(line, sets) * ways
    idx = base[:, None] + way_off
    hit, hit_way = (tags.take(idx) == line[:, None]).max(dim=1)
    pos = base + torch.where(hit, hit_way, words.take(idx).argmin(dim=1))
    old_tag, old_word = tags.take(pos), words.take(pos)
    old_dirty = old_word & 1
    writeback = (old_tag >= 0) & (old_dirty == 1)
    miss_cost = hit_cost + mem_latency
    cycles = torch.where(hit, hit_cost, torch.where(
        writeback, miss_cost + mem_latency, miss_cost))
    word = torch.where(hit, old_dirty | is_write, is_write) | _i32(now << 1)
    tags[pos] = torch.where(active, line, old_tag)
    words[pos] = torch.where(active, word, old_word)
    return torch.where(active, cycles, 0), hit


def _grid_lanes(P: int, cfg, mach, device):
    """Per-lane program index, config values and machine values of the
    flattened (P, C, M) grid, lane = (p * C + c) * M + m."""
    capacity, policy, anf = (torch.as_tensor(a, device=device)
                             for a in cfg)
    l1h, uop, mem = (torch.as_tensor(a, dtype=torch.int32, device=device)
                     for a in mach)
    C, M = capacity.shape[0], l1h.shape[0]
    p_of = torch.arange(P, device=device).repeat_interleave(C * M)
    c_of = torch.arange(C, device=device).repeat_interleave(M).repeat(P)
    m_of = torch.arange(M, device=device).repeat(P * C)
    return (p_of, capacity.to(torch.int32)[c_of],
            policy.to(torch.int32)[c_of], anf.to(torch.bool)[c_of],
            l1h[m_of], uop[m_of], mem[m_of], C, M)


def engine_scan_plain(x, spill0s, cfg, mach, *, l1_sets: int,
                      l1_ways: int, track_ab: bool = True, lengths=None,
                      cores: int | None = None, strides=None,
                      row_hook=None, width: int = NUM_COUNTERS):
    """The engine in plain torch: the reference's ``_make_step`` /
    ``_make_body`` with the P x C x M lanes flattened onto one batch
    dimension, one Python iteration per instruction row.  The CPU path
    and the kernel's oracle; it costs one to a few milliseconds a row on
    a CPU, so it serves reduced-size traces.  Returns ``(ctr, ctr_a, ctr_b)``,
    (P, C, M, 12) int32 each.

    ``cores`` runs N cores of a cluster per (program, config, machine)
    lane, core n's spill and data lines shifted by ``n * strides[p]``
    (wrapping as int32), each with its own cVRF and L1; ``row_hook(t,
    inc, miss)`` then takes each row's (lanes, 12) increments and its
    (lanes, 8) L1-missed lines (-1 where a site hit or was inactive) and
    returns the (lanes, ``width``) increments to count, and the counters
    are (P, C, M, N, ``width``).

    Its tensors are a few thousand elements, too small to share among
    threads, so it runs with one intra-op thread: torch's other threads
    would otherwise spin between its operations on every idle core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _scan_rows(x, spill0s, cfg, mach, l1_sets=l1_sets,
                          l1_ways=l1_ways, track_ab=track_ab,
                          lengths=lengths, cores=cores, strides=strides,
                          row_hook=row_hook, width=width)
    finally:
        torch.set_num_threads(threads)


def _scan_rows(x, spill0s, cfg, mach, *, l1_sets, l1_ways, track_ab,
               lengths, cores, strides, row_hook, width):
    P, T, ncol = x.shape
    if ncol != NCOL:
        raise ValueError(f"x has {ncol} columns, want {NCOL}")
    dev = x.device
    (p_of, cap, pol, anf, hit_d, hit_u, lat, C, M) = _grid_lanes(
        P, cfg, mach, dev)
    N = cores or 1
    p_of, cap, pol, anf, hit_d, hit_u, lat = (
        a.repeat_interleave(N) for a in (p_of, cap, pol, anf, hit_d, hit_u,
                                         lat))
    B = P * C * M * N
    base = torch.zeros(B, dtype=torch.long, device=dev)
    if cores:
        base = torch.arange(N, device=dev).repeat(P * C * M) * torch.as_tensor(
            strides, device=dev).to(torch.long)[p_of]
    sp0 = _wrap32(torch.as_tensor(spill0s, device=dev).to(torch.long)[p_of]
                  + base).to(torch.int32)
    mem_base = _wrap32(base).to(torch.int32)
    walk = T if lengths is None else int(max(lengths, default=0))
    full = cap >= NUM_ARCH_VREGS
    nfull = ~full
    valid = torch.arange(NUM_ARCH_VREGS, device=dev)[None, :] < cap[:, None]
    lanes = torch.arange(B, device=dev)
    cache = policies.CacheState.init(NUM_ARCH_VREGS, B, dev)
    l1 = l1_init(B, l1_sets, l1_ways, dev)
    seq = torch.zeros(B, dtype=torch.int32, device=dev)
    ctr = torch.zeros((B, width), dtype=torch.int32, device=dev)
    ctr_a, ctr_b = torch.zeros_like(ctr), torch.zeros_like(ctr)
    yes = torch.ones(B, dtype=torch.bool, device=dev)
    no = ~yes
    # Rows no lane touches (padding, and absent lanes) are skipped by
    # Python branches on these host-side flags; skipping them changes no
    # state and no counter.
    live = (x[:, :walk, RV:RV + 3] != 0).any(dim=0).tolist()
    live_mem = (x[:, :walk, MV:MV + 2] != 0).any(dim=0).tolist()
    by_row = x.permute(1, 2, 0)                         # (T, NCOL, P)

    for t in range(walk):
        xr = by_row[t][:, p_of] if P > 1 else by_row[t].expand(NCOL, B)
        now0 = _i32(NOW_STEP * t)
        # The row's increments as (counter, value) terms: cycle counts
        # (int32) and event flags (bool), summed into `inc` at the end.
        cyc = [(CYCLES, xr[COST])]
        flags = []
        miss_lines = torch.full((B, SITES), -1, dtype=torch.int32,
                                device=dev) if row_hook else None
        for s in range(3):
            if not live[t][s]:
                continue
            active = xr[RV + s] != 0
            rg = xr[REG + s]
            now = _i32(now0 + s)
            wr = xr[VDW] != 0 if s == 2 else no
            rd = xr[VDR] != 0 if s == 2 else yes
            raw_hit, slot = policies.lookup(cache, rg, valid)
            raw_hit = raw_hit & active
            miss = active & ~raw_hit & nfull
            any_miss = bool(miss.any())
            tslot = slot
            if any_miss:
                has_free, fslot = policies.free_slot(cache, valid)
                victim = policies.select_victim(
                    cache, pol, valid, xr[LK1] if s >= 1 else -1,
                    xr[LK2] if s == 2 else -1)
                tslot = torch.where(has_free, fslot, victim)
                vrow = cache.meta[lanes, victim]
                do_spill = miss & ~has_free & (vrow[:, policies.DIRTY] == 1)
                do_fill = (miss & (rd | ~((xr[VDNF] != 0) & anf))
                           if s == 2 else miss)
                # Spill the evictee to its reserved line, then fill the
                # missing register: both uops through the L1.
                for site, do, line, is_w, ctr_k in (
                        (2 * s, do_spill, vrow[:, policies.TAG], True,
                         SPILLS),
                        (2 * s + 1, do_fill, rg, False, FILLS)):
                    if bool(do.any()):
                        line = sp0 + line.clamp(min=0)
                        c, h = l1_access(l1, line, is_w, now, do, hit_u, lat)
                        cyc += [(CYCLES, c), (STALL, c)]
                        flags += [(ctr_k, do), (L1_HITS, do & h),
                                  (L1_MISSES, do & ~h)]
                        if row_hook:
                            miss_lines[:, site] = torch.where(do & ~h, line,
                                                              -1)
                flags.append((MISSES, miss))
            touch = active & nfull
            if bool(touch.any()):
                policies.apply_access(
                    cache, active=touch, raw_hit=raw_hit, hit_slot=slot,
                    install_slot=tslot, tag=rg, now=now, seq=seq,
                    next_use=xr[NXT + s], is_write=wr)
            if any_miss:
                seq = seq + miss.to(torch.int32)
            flags += [(HITS, raw_hit | (active & full)),
                      (REG_READS, active & rd), (REG_WRITES, active & wr)]
        for m in range(2):
            if not live_mem[t][m]:
                continue
            active = xr[MV + m] != 0
            is_w = xr[MW + m] != 0
            line = xr[ML + m] + mem_base
            c, h = l1_access(l1, line, is_w, _i32(now0 + 3 + m), active,
                             hit_d, lat)
            if row_hook:
                miss_lines[:, REG_SITES + m] = torch.where(active & ~h, line,
                                                           -1)
            cyc.append((CYCLES, c))
            flags += [(L1_HITS, active & h), (L1_MISSES, active & ~h),
                      (MEM_READS, active & ~is_w),
                      (MEM_WRITES, active & is_w)]
        inc = torch.zeros((B, NUM_COUNTERS), dtype=torch.int32, device=dev)
        for terms in (cyc, flags):
            if terms:
                k, v = zip(*terms)
                inc.index_add_(1, torch.tensor(k, device=dev),
                               torch.stack(v, dim=1).to(torch.int32))
        if row_hook:
            inc = row_hook(t, inc, miss_lines)
        ctr += inc * xr[WT][:, None]
        if track_ab:
            ctr_a += inc * xr[WA][:, None]
            ctr_b += inc * xr[WB][:, None]
    shape = (P, C, M) + ((N,) if cores else ()) + (width,)
    return ctr.view(shape), ctr_a.view(shape), ctr_b.view(shape)


# -------------------------------------------------------------- the split --

def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """An int64 tensor wrapped to the int32 range, as int32 sums wrap."""
    return torch.remainder(v + 2**31, 2**32) - 2**31


def cvrf_classes(capacity, policy, alloc_no_fetch) -> list[int]:
    """Each config's cVRF class: -1 for a full VRF (capacity >= 32: every
    REG access hits, so there is no cVRF state, spill or fill), else the
    index of the first config with the same (capacity, policy,
    alloc_no_fetch), whose cVRF pass it shares."""
    seen, out = {}, []
    for c, key in enumerate(zip(np.asarray(capacity).tolist(),
                                np.asarray(policy).tolist(),
                                np.asarray(alloc_no_fetch).tolist())):
        full = key[0] >= NUM_ARCH_VREGS
        out.append(-1 if full else seen.setdefault(
            (key[0], key[1], bool(key[2])), c))
    return out


def _tiles(T: int) -> int:
    return max(1, -(-T // TILE_ROWS))


def engine_scan_plan(l1_sets: int, l1_ways: int, lengths=(), cfg=None, *,
                     T: int | None = None) -> dict:
    """The split the card runs for an L1 of ``l1_sets`` x ``l1_ways`` over
    programs of ``lengths`` rows (padded to ``T``) and the configs ``cfg``
    (capacity, policy, alloc_no_fetch): the kernels' ``tile`` (the
    :data:`TILE_KEYS` figures the built library states), each config's
    cVRF class, and the launch groups.  A group lists its K1a lanes
    (program, class), its K1b lanes (program, class, index of its K1a
    lane or -1 for the full VRF), its outputs (program, config, K1b lane)
    and the bytes of its buffers; groups hold consecutive K1b lanes whose
    buffers fit :data:`STREAM_BUDGET_BYTES`.  Raises ``ValueError`` for what the
    kernels do not take: ways outside 1..32 (the walker keeps the set's
    ways in registers), a set count whose bucketing counters pass the
    CTA's shared memory, or ``MAX_ROWS`` rows or more."""
    hist_smem = HIST_WARPS_PER_CTA * l1_sets * 4
    if l1_sets < 1 or not 1 <= l1_ways <= 32 or hist_smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"engine_scan takes 1..32 ways and at most {MAX_SMEM_BYTES} "
            f"bytes of shared memory, got {l1_sets} sets x {l1_ways} ways "
            f"({hist_smem} bytes)")
    lengths = [int(n) for n in lengths]
    T = max(lengths, default=0) if T is None else int(T)
    if T >= MAX_ROWS:
        raise ValueError(f"engine_scan takes fewer than {MAX_ROWS} rows, "
                         f"got {T}")
    tile = dict(reg_warps_per_cta=REG_WARPS_PER_CTA, chunk_rows=CHUNK_ROWS,
                ncol=NCOL, reg_smem_bytes=REG_WARPS_PER_CTA * CHUNK_ROWS * (
                    NCOL * 4 + REG_SITES),
                tile_rows=TILE_ROWS, hist_warps_per_cta=HIST_WARPS_PER_CTA,
                hist_smem_bytes=hist_smem,
                way_slots=1 << (l1_ways - 1).bit_length(),
                walk_threads=WALK_THREADS)
    classes = cvrf_classes(*cfg) if cfg is not None else []
    kinds = list(dict.fromkeys(classes))
    hist = l1_sets * _tiles(T) * 4
    groups, group = [], None
    for p, n in enumerate(lengths):
        for k in kinds:
            need = dict(stream=T * REG_SITES if k >= 0 else 0,
                        records=n * (SITES if k >= 0 else 2) * RECORD_BYTES,
                        hist=hist)
            if group is None or (group["l1_lanes"] and sum(
                    group["bytes"].values()) + sum(need.values())
                    > STREAM_BUDGET_BYTES):
                group = dict(reg_lanes=[], l1_lanes=[], outputs=[],
                             bytes=dict.fromkeys(need, 0))
                groups.append(group)
            reg = -1
            if k >= 0:
                reg = len(group["reg_lanes"])
                group["reg_lanes"].append((p, k))
            group["l1_lanes"].append((p, k, reg))
            group["outputs"] += [(p, c, len(group["l1_lanes"]) - 1)
                                 for c, kc in enumerate(classes) if kc == k]
            for key, v in need.items():
                group["bytes"][key] += v
    return dict(route="split", tile=tile, classes=classes, groups=groups,
                budget_bytes=STREAM_BUDGET_BYTES)


def _lane_lengths(lengths, P: int, T: int, device) -> torch.Tensor:
    return torch.as_tensor([T] * P if lengths is None else lengths,
                           device=device).to(torch.long).reshape(-1)


def engine_reg_plain(x, prog, cfg, *, track_ab: bool = True, lengths=None):
    """K1a in plain torch: the cVRF half of the reference's ``_make_body``
    (lookup, free slot, victim, spill, fill, ``apply_access``) over R
    lanes, lane r walking program ``prog[r]``'s rows with config
    ``cfg[.][r]`` (capacity < 32 each).  Returns the spill/fill stream,
    (R, T, REG_SITES) int8 (the register spilled or filled, -1 where the
    site is inactive or the row lies past the lane's length), and the
    (R, NUM_SETS, 6) int32 counters of :data:`REG_COUNTERS`, summed over
    rows times ``wt``/``wa``/``wb`` (periods zero unless ``track_ab``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _reg_rows(x, prog, cfg, track_ab, lengths)
    finally:
        torch.set_num_threads(threads)


def _reg_rows(x, prog, cfg, track_ab, lengths):
    P, T, _ = x.shape
    dev = x.device
    prog = torch.as_tensor(prog, device=dev).to(torch.long).reshape(-1)
    cap, pol, anf = (torch.as_tensor(a, device=dev) for a in cfg)
    cap, pol, anf = cap.to(torch.int32), pol.to(torch.int32), anf.bool()
    if bool((cap >= NUM_ARCH_VREGS).any()):
        raise ValueError("engine_reg: a full VRF (capacity >= 32) has no "
                         "cVRF pass")
    R = prog.shape[0]
    lane_len = _lane_lengths(lengths, P, T, dev)[prog]
    stream = torch.full((R, T, REG_SITES), -1, dtype=torch.int8, device=dev)
    ctr = torch.zeros((R, NUM_SETS, len(REG_COUNTERS)), dtype=torch.int32,
                      device=dev)
    walk = int(lane_len.max()) if R else 0
    valid = torch.arange(NUM_ARCH_VREGS, device=dev)[None, :] < cap[:, None]
    lanes = torch.arange(R, device=dev)
    cache = policies.CacheState.init(NUM_ARCH_VREGS, R, dev)
    seq = torch.zeros(R, dtype=torch.int32, device=dev)
    yes = torch.ones(R, dtype=torch.bool, device=dev)
    no = ~yes
    nsets = NUM_SETS if track_ab else 1
    live = (x[:, :walk, RV:RV + 3] != 0).any(dim=0).tolist()
    by_row = x.permute(1, 2, 0)                         # (T, NCOL, P)
    for t in range(walk):
        xr = by_row[t][:, prog]
        inside = t < lane_len
        now0 = _i32(NOW_STEP * t)
        flags = []                      # (index in REG_COUNTERS, flags)
        for s in range(3):
            if not live[t][s]:
                continue
            active = (xr[RV + s] != 0) & inside
            rg = xr[REG + s]
            wr = xr[VDW] != 0 if s == 2 else no
            rd = xr[VDR] != 0 if s == 2 else yes
            raw_hit, slot = policies.lookup(cache, rg, valid)
            raw_hit = raw_hit & active
            miss = active & ~raw_hit
            tslot = slot
            if bool(miss.any()):
                has_free, fslot = policies.free_slot(cache, valid)
                victim = policies.select_victim(
                    cache, pol, valid, xr[LK1] if s >= 1 else -1,
                    xr[LK2] if s == 2 else -1)
                tslot = torch.where(has_free, fslot, victim)
                vrow = cache.meta[lanes, victim]
                do_spill = miss & ~has_free & (vrow[:, policies.DIRTY] == 1)
                do_fill = (miss & (rd | ~((xr[VDNF] != 0) & anf))
                           if s == 2 else miss)
                stream[:, t, 2 * s] = torch.where(
                    do_spill, vrow[:, policies.TAG].clamp(min=0), -1)
                stream[:, t, 2 * s + 1] = torch.where(do_fill,
                                                      rg.clamp(min=0), -1)
                flags += [(2, do_spill), (3, do_fill)]
            policies.apply_access(
                cache, active=active, raw_hit=raw_hit, hit_slot=slot,
                install_slot=tslot, tag=rg, now=_i32(now0 + s), seq=seq,
                next_use=xr[NXT + s], is_write=wr)
            seq = seq + miss.to(torch.int32)
            flags += [(0, raw_hit), (1, miss), (4, active & rd),
                      (5, active & wr)]
        if flags:
            k, v = zip(*flags)
            inc = torch.zeros((R, len(REG_COUNTERS)), dtype=torch.int32,
                              device=dev).index_add_(
                1, torch.tensor(k, device=dev),
                torch.stack(v, dim=1).to(torch.int32))
            w = torch.stack([xr[WT], xr[WA], xr[WB]][:nsets], dim=1)
            ctr[:, :nsets] += inc[:, None, :] * w[:, :, None]
    return stream, ctr


def l1_accesses(x, spill0s, stream, l1_prog, l1_reg, lengths=None,
                l1_base=None):
    """Every active L1 access of each K1b lane, in engine order (row, then
    site): lane j walks program ``l1_prog[j]``'s rows, with K1a lane
    ``l1_reg[j]``'s spills and fills at sites 0..5 (none for -1, the full
    VRF) and the row's MEM lanes at sites 6 and 7.  Returns (N,) int64
    tensors ``lane, row, site, line, write`` sorted by (lane, row, site);
    a spill or fill goes to ``spill0 + register``, wrapping as int32.
    ``l1_base`` (L,) shifts every line of a lane (a cluster core's address
    colour; default 0), wrapping as int32 too."""
    P, T, _ = x.shape
    dev = x.device
    prog = torch.as_tensor(l1_prog, device=dev).to(torch.long).reshape(-1)
    reg = torch.as_tensor(l1_reg, device=dev).to(torch.long).reshape(-1)
    L = prog.shape[0]
    xp = x[prog].long()                                 # (L, T, NCOL)
    inside = (torch.arange(T, device=dev)[None, :]
              < _lane_lengths(lengths, P, T, dev)[prog][:, None])
    regs = torch.full((L, T, REG_SITES), -1, dtype=torch.long, device=dev)
    if stream.shape[0]:
        regs = torch.where((reg >= 0)[:, None, None],
                           stream[reg.clamp(min=0)].long(), regs)
    sp0 = torch.as_tensor(spill0s, device=dev).to(torch.long)[prog]
    base = torch.zeros(L, dtype=torch.long, device=dev) if l1_base is None \
        else torch.as_tensor(l1_base, device=dev).to(torch.long).reshape(-1)
    line = _wrap32(torch.cat([sp0[:, None, None] + regs.clamp(min=0),
                              xp[..., ML:ML + 2]], dim=2)
                   + base[:, None, None])
    active = torch.cat([regs >= 0, xp[..., MV:MV + 2] != 0],
                       dim=2) & inside[..., None]
    spill = torch.tensor([1, 0] * 3, dtype=torch.long, device=dev)
    write = torch.cat([spill.expand(L, T, REG_SITES),
                       (xp[..., MW:MW + 2] != 0).long()], dim=2)
    lane, row, site = active.nonzero(as_tuple=True)
    return lane, row, site, line[lane, row, site], write[lane, row, site]


def _stamp(row, site):
    """An access's ``now << 1``, the L1 word without its dirty bit:
    ``now`` is ``NOW_STEP * row`` plus the REG slot (sites 0..5) or 3 + the
    MEM lane (sites 6, 7), wrapped as the reference's int32."""
    off = torch.where(site < REG_SITES, site // 2, site - 3)
    return _wrap32(2 * (NOW_STEP * row + off))


def _l1_visit(l1, line, write, stamp):
    """One access on each of n L1s (tags, words: (n, sets, ways) int64),
    as ``l1_access`` does it; returns (miss, write-back) flags."""
    tags, words = l1
    n, sets, _ = tags.shape
    ar = torch.arange(n, device=tags.device)
    s = torch.remainder(line, sets)
    tset, wset = tags[ar, s], words[ar, s]
    hit, hit_way = (tset == line[:, None]).max(dim=1)
    way = torch.where(hit, hit_way, wset.argmin(dim=1))
    old_tag, old_word = tset[ar, way], wset[ar, way]
    old_dirty = old_word & 1
    wb = ~hit & (old_tag >= 0) & (old_dirty == 1)
    tags[ar, s, way] = line
    words[ar, s, way] = stamp | torch.where(hit, old_dirty | write, write)
    return ~hit, wb


def _walk(group, line, write, stamp, groups: int, sets: int, ways: int):
    """Walk each group's accesses in their order through the group's own
    L1 of ``sets`` x ``ways``; ``group`` is sorted and each group's
    accesses lie in walk order.  Step k takes the k-th access of every
    group at once.  Returns the (miss, write-back) flags per access."""
    N = group.shape[0]
    dev = group.device
    miss = torch.zeros(N, dtype=torch.bool, device=dev)
    wb = torch.zeros_like(miss)
    if N == 0:
        return miss, wb
    idx = torch.arange(N, device=dev)
    first = torch.ones_like(miss)
    first[1:] = group[1:] != group[:-1]
    rank = idx - torch.where(first, idx, 0).cummax(dim=0).values
    order = torch.sort(rank, stable=True).indices
    tags = torch.full((groups, sets, ways), -1, dtype=torch.long, device=dev)
    words = torch.zeros_like(tags)
    lo = 0
    for n in torch.bincount(rank).tolist():
        ids = order[lo:lo + n]
        lo += n
        g = group[ids]
        l1 = (tags[g], words[g])
        miss[ids], wb[ids] = _l1_visit(l1, line[ids], write[ids], stamp[ids])
        tags[g], words[g] = l1
    return miss, wb


def l1_outcomes(lane, line, write, stamp, lanes: int, l1_sets: int,
                l1_ways: int, by_set: bool = True):
    """The (miss, write-back) flags of accesses in engine order (sorted by
    lane).  ``by_set`` walks each (lane, set) bucket on its own, as K1b
    does: a stable sort by set keeps each bucket in engine order.
    Otherwise each lane walks its whole stream through its L1."""
    if not by_set:
        return _walk(lane, line, write, stamp, lanes, l1_sets, l1_ways)
    key = lane * l1_sets + torch.remainder(line, l1_sets)
    order = torch.sort(key, stable=True).indices
    m, w = _walk(key[order], line[order], write[order], stamp[order],
                 lanes * l1_sets, 1, l1_ways)
    miss, wb = torch.empty_like(m), torch.empty_like(w)
    miss[order], wb[order] = m, w
    return miss, wb


def trace_sums(x, lengths=None) -> torch.Tensor:
    """The (P, NUM_SETS, TRACE_SUMS) int64 sums over each program's rows
    of cost, REG accesses, REG reads and writes, MEM reads and writes,
    times ``wt``, ``wa`` and ``wb`` (not wrapped)."""
    P, T, _ = x.shape
    x = x.long()
    inside = (torch.arange(T, device=x.device)[None, :]
              < _lane_lengths(lengths, P, T, x.device)[:, None])
    act = (x[..., RV:RV + 3] != 0) & inside[..., None]
    mv = (x[..., MV:MV + 2] != 0) & inside[..., None]
    mw = x[..., MW:MW + 2] != 0
    reads = act[..., 0].long() + act[..., 1] + (act[..., 2]
                                               & (x[..., VDR] != 0))
    vals = torch.stack([x[..., COST] * inside, act.sum(-1), reads,
                        (act[..., 2] & (x[..., VDW] != 0)).long(),
                        (mv & ~mw).sum(-1), (mv & mw).sum(-1)], dim=-1)
    w = x[..., WT:WB + 1]
    return (w[..., :, None] * vals[..., None, :]).sum(dim=1)


def l1_sums(x, l1_prog, lane, row, site, miss, wb, lanes: int):
    """The (lanes, NUM_SETS, L1_SUMS) int64 weighted accesses, misses and
    write-backs per class (uop: sites 0..5, data: 6 and 7)."""
    prog = torch.as_tensor(l1_prog, device=x.device).to(torch.long)
    w = x[prog[lane], row, WT:WB + 1].long()            # (N, sets)
    vals = torch.stack([torch.ones_like(row), miss.long(), wb.long()], -1)
    out = torch.zeros((lanes * 2, NUM_SETS, 3), dtype=torch.long,
                      device=x.device)
    out.index_add_(0, lane * 2 + (site >= REG_SITES).long(),
                   w[:, :, None] * vals[:, None, :])
    return out.view(lanes, 2, NUM_SETS, 3).transpose(1, 2).reshape(
        lanes, NUM_SETS, L1_SUMS)


def l1_finish(tsum, sums, reg_ctr, l1_prog, l1_reg, out_l1, mach, *,
              track_ab: bool):
    """K1b's closed form per machine: the (Q, M, 12) int32 counters
    ``(ctr, ctr_a, ctr_b)`` of the outputs ``out_l1`` (their K1b lanes)
    from the trace sums (P, NUM_SETS, TRACE_SUMS), the L1 sums (L,
    NUM_SETS, L1_SUMS) and K1a's counters (R, NUM_SETS, 6); stall and
    memory cycles are linear in the latencies given the sums."""
    dev = sums.device
    j = torch.as_tensor(out_l1, device=dev).to(torch.long).reshape(-1)
    p = torch.as_tensor(l1_prog, device=dev).to(torch.long)[j]
    r = torch.as_tensor(l1_reg, device=dev).to(torch.long)[j]
    ts, s = tsum[p].long(), sums[j].long()              # (Q, sets, 6)
    full = torch.stack([ts[..., 1]] + [torch.zeros_like(ts[..., 1])] * 3
                       + [ts[..., 2], ts[..., 3]], dim=-1)
    rc = full
    if reg_ctr.shape[0]:
        rc = torch.where((r >= 0)[:, None, None],
                         reg_ctr[r.clamp(min=0)].long(), full)
    hd, hu, lat = (torch.as_tensor(a, device=dev).to(torch.long)
                   for a in mach)
    au, mu, wu, ad, md, wd = (s[..., i] for i in range(L1_SUMS))
    M = hd.shape[0]
    per = lambda v: v[..., None].expand(*v.shape, M)  # noqa: E731
    stall = hu * per(au) + lat * per(mu + wu)           # (Q, sets, M)
    memc = hd * per(ad) + lat * per(md + wd)
    out = torch.stack([
        per(ts[..., 0]) + stall + memc, stall, per(rc[..., 0]),
        per(rc[..., 1]), per(rc[..., 2]), per(rc[..., 3]),
        per(au - mu + ad - md), per(mu + md), per(rc[..., 4]),
        per(rc[..., 5]), per(ts[..., 4]), per(ts[..., 5])],
        dim=-1)                                         # (Q, sets, M, 12)
    out = _wrap32(out).to(torch.int32)
    if not track_ab:
        out[:, 1:] = 0
    return tuple(out[:, i].contiguous() for i in range(NUM_SETS))


def engine_l1_plain(x, spill0s, stream, reg_ctr, l1_prog, l1_reg, out_l1,
                    mach, *, l1_sets: int, l1_ways: int,
                    track_ab: bool = True, lengths=None, l1_base=None,
                    keep: bool = False):
    """K1b in plain torch: the L1 half of the reference's ``_make_body``
    (``_l1_access`` on the spill, fill and MEM accesses) for K1b lanes
    (``l1_prog``, ``l1_reg``, ``l1_base``: see :func:`l1_accesses`),
    walked by (lane, set) bucket once for all machine points, then
    :func:`l1_finish` for the outputs ``out_l1``.  ``stream`` and
    ``reg_ctr`` are K1a's.  Returns ``(ctr, ctr_a, ctr_b)``, (Q, M, 12)
    int32 each; with ``keep``, also the lanes' accesses (``lane, row,
    site, line``) and their ``miss`` flags, the L1-miss stream a
    cluster's shared L2 takes (``kernels/cluster_scan.py``)."""
    lane, row, site, line, write = l1_accesses(x, spill0s, stream, l1_prog,
                                               l1_reg, lengths, l1_base)
    L = len(l1_prog)
    miss, wb = l1_outcomes(lane, line, write, _stamp(row, site), L, l1_sets,
                           l1_ways)
    sums = l1_sums(x, l1_prog, lane, row, site, miss, wb, L)
    out = l1_finish(trace_sums(x, lengths), sums, reg_ctr, l1_prog, l1_reg,
                    out_l1, mach, track_ab=track_ab)
    if keep:
        return out, dict(lane=lane, row=row, site=site, line=line, miss=miss)
    return out


def _split_run(x, spill0s, cfg, mach, *, l1_sets, l1_ways, track_ab,
               lengths, reg_fn, l1_fn):
    """K1 as the split: per launch group of :func:`engine_scan_plan`, the
    cVRF pass ``reg_fn`` on its K1a lanes, then the L1 pass ``l1_fn``,
    whose outputs land at their (program, config) in the (P, C, M, 12)
    counters."""
    P, T, _ = x.shape
    dev = x.device
    host_cfg = tuple(np.asarray(torch.as_tensor(a).cpu()) for a in cfg)
    host_len = None if lengths is None else torch.as_tensor(
        lengths).cpu().tolist()
    plan = engine_scan_plan(l1_sets, l1_ways,
                            [T] * P if host_len is None else host_len,
                            host_cfg, T=T)
    C, M = len(host_cfg[0]), len(mach[0])
    outs = [torch.zeros((P * C, M, NUM_COUNTERS), dtype=torch.int32,
                        device=dev) for _ in range(NUM_SETS)]
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
        l1_prog, _, l1_reg = zip(*g["l1_lanes"])
        p, c, j = zip(*g["outputs"])
        res = l1_fn(x, spill0s, stream, reg_ctr, list(l1_prog),
                    list(l1_reg), list(j), mach, l1_sets=l1_sets,
                    l1_ways=l1_ways, **kw)
        at = torch.as_tensor(np.asarray(p) * C + np.asarray(c), device=dev)
        for o, r in zip(outs, res):
            o[at] = r
    return tuple(o.view(P, C, M, NUM_COUNTERS) for o in outs)


def engine_split_plain(x, spill0s, cfg, mach, *, l1_sets: int, l1_ways: int,
                       track_ab: bool = True, lengths=None):
    """The split in plain torch, as :func:`engine_scan_cuda` runs it on the
    card (the same plan and groups): :func:`engine_reg_plain` then
    :func:`engine_l1_plain`.  Returns what :func:`engine_scan_plain`
    returns."""
    return _split_run(
        x, spill0s, cfg, mach, l1_sets=l1_sets, l1_ways=l1_ways,
        track_ab=track_ab, lengths=lengths, reg_fn=engine_reg_plain,
        l1_fn=engine_l1_plain)


# ------------------------------------------------------------ on the card --

# The C entry points' parameters (csrc/engine_scan.cu).
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ARGTYPES = {
    "engine_reg_launch": [_P, _I, _LL, _P, _P, _P, _P, _P, _I, _I, _P, _P,
                          _P],
    "engine_l1_launch": ([_P, _I, _LL, _P, _P, _P, _P, _I, _P, _P, _I, _P,
                          _I, _P, _P, _P, _I, _I, _I, _I, _P, _LL]
                         + [_P] * 11),
    "engine_scan_tile": [_I, _I, _P],
}
TILE_KEYS = ("reg_warps_per_cta", "chunk_rows", "ncol", "reg_smem_bytes",
             "tile_rows", "hist_warps_per_cta", "hist_smem_bytes",
             "way_slots", "walk_threads")


@functools.cache
def _library():
    """The built library, loaded once, with every entry point's ctypes
    signature set."""
    from repro_torch.kernels import _build

    lib = _build.load("engine_scan")
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def built_tile(l1_sets: int, l1_ways: int) -> dict:
    """The built kernels' tile for an L1 geometry (``engine_scan_tile``):
    the :data:`TILE_KEYS` figures that :func:`engine_scan_plan` must
    state."""
    out = (ctypes.c_int * len(TILE_KEYS))()
    if _library().engine_scan_tile(l1_sets, l1_ways, out):
        raise ValueError(f"engine_scan does not take {l1_sets} sets x "
                         f"{l1_ways} ways")
    return dict(zip(TILE_KEYS, out))


def _int32_on(a, device, name):
    """An integer or boolean array (list, numpy or tensor) as a contiguous
    int32 tensor on ``device``; raises for other types and for values
    outside the int32 range."""
    t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                        else a)
    if t.dtype.is_floating_point or t.dtype.is_complex:
        raise ValueError(f"engine_scan_cuda: {name} must be integer or "
                         f"bool, got {t.dtype}")
    if t.dtype not in (torch.bool, torch.int32) and t.numel() and (
            int(t.min()) < -2**31 or int(t.max()) >= 2**31):
        raise ValueError(f"engine_scan_cuda: {name} exceeds int32")
    return t.to(device=device, dtype=torch.int32).contiguous()


def _rows_on_card(x, who):
    if not x.is_cuda:
        raise ValueError(f"{who} needs x on a CUDA device, got {x.device}")
    if (x.dtype != torch.int32 or x.dim() != 3 or x.shape[2] != NCOL
            or x.shape[0] == 0):
        raise ValueError(f"{who} needs x (P, T, {NCOL}) int32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    return x.contiguous()


def _launch(x, entry, *args, library=None):
    """Call a C entry point of ``library`` (default: this module's) on x's
    card and current stream; raises on a refused geometry (-1) and on a
    failed launch."""
    dev = x.device
    ctx = (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
           else torch.cuda.device(dev))
    with ctx:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr((library or _library)(), entry)(*args, stream)
    if err == -1:
        raise ValueError(f"{entry}: the kernel refused its arguments")
    if err:
        raise RuntimeError(f"{entry} failed: cudaError {err}")


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


@RouteCounted.over("warp")
def engine_reg_cuda(x, prog, cfg, *, track_ab: bool = True, lengths=None):
    """Launch K1a on a CUDA tensor ``x`` (P, T, NCOL) int32 for the R lanes
    ``prog`` (R,) with configs ``cfg`` (capacity < 32); returns what
    :func:`engine_reg_plain` returns (the stream only where rows lie within
    a lane's length).  Raises on what the kernel does not take and on a
    failed launch; never falls back."""
    x = _rows_on_card(x, "engine_reg_cuda")
    P, T, _ = x.shape
    dev = x.device
    lengths = _int32_on([T] * P if lengths is None else lengths, dev,
                        "lengths")
    prog = _int32_on(prog, dev, "prog")
    cfg = [_int32_on(a, dev, n) for a, n in zip(
        cfg, ("capacity", "policy", "alloc_no_fetch"))]
    R = prog.shape[0]
    if prog.dim() != 1 or any(a.shape != (R,) for a in cfg) or R == 0:
        raise ValueError("engine_reg_cuda: prog and the config arrays must "
                         "be (R,), R > 0")
    if int(prog.min()) < 0 or int(prog.max()) >= P:
        raise ValueError(f"engine_reg_cuda: prog must lie in [0, {P})")
    if int(cfg[0].max()) >= NUM_ARCH_VREGS:
        raise ValueError("engine_reg_cuda: a full VRF (capacity >= 32) has "
                         "no cVRF pass")
    stream = torch.empty((R, T, REG_SITES), dtype=torch.int8, device=dev)
    ctr = torch.zeros((R, NUM_SETS, len(REG_COUNTERS)), dtype=torch.int32,
                      device=dev)
    _launch(x, "engine_reg_launch", x.data_ptr(), P, T,
            *_ptrs(lengths, prog, *cfg), R, int(bool(track_ab)),
            *_ptrs(stream, ctr))
    engine_reg_cuda.count(dict(route="warp"))
    return stream, ctr


@RouteCounted.over("set")
def engine_l1_cuda(x, spill0s, stream, reg_ctr, l1_prog, l1_reg, out_l1,
                   mach, *, l1_sets: int, l1_ways: int,
                   track_ab: bool = True, lengths=None, l1_base=None,
                   keep: bool = False):
    """Launch K1b on a CUDA tensor ``x``: bucket the K1b lanes' accesses
    by set, walk each (lane, set) bucket on one thread, reduce over sets
    and apply the closed form per machine.  Arguments and result as
    :func:`engine_l1_plain`'s, but ``keep`` returns K1b's own buffers:
    the bucketed records (``recs``: line, ``row << 4 | site << 1 |
    write``), their ``outcome`` bytes (``miss | write-back << 1``), the
    bucket offsets ``hist`` and what indexes them (``tiles``, ``slots``:
    each lane's first access slot in engine order).  Raises on what the
    kernels do not take and on a failed launch; never falls back."""
    x = _rows_on_card(x, "engine_l1_cuda")
    P, T, _ = x.shape
    dev = x.device
    engine_scan_plan(l1_sets, l1_ways, T=T)   # raises on what K1b refuses
    host_len = [T] * P if lengths is None else torch.as_tensor(
        lengths).cpu().tolist()
    lengths = _int32_on(host_len, dev, "lengths")
    spill0s = _int32_on(spill0s, dev, "spill0s")
    host_prog, host_reg, host_out = (
        _int32_on(a, "cpu", n).tolist() for a, n in (
            (l1_prog, "l1_prog"), (l1_reg, "l1_reg"), (out_l1, "out_l1")))
    prog, reg, out_l1 = (_int32_on(a, dev, "lanes")
                         for a in (host_prog, host_reg, host_out))
    mach = [_int32_on(a, dev, n) for a, n in zip(
        mach, ("l1_hit_cycles", "uop_hit_cycles", "mem_latency"))]
    L, Q, M, R = prog.shape[0], out_l1.shape[0], mach[0].shape[0], (
        stream.shape[0])
    if (L == 0 or Q == 0 or reg.shape != (L,) or spill0s.shape != (P,)
            or any(a.shape != (M,) for a in mach)
            or tuple(stream.shape) != (R, T, REG_SITES)
            or stream.dtype != torch.int8
            or tuple(reg_ctr.shape) != (R, NUM_SETS, len(REG_COUNTERS))):
        raise ValueError("engine_l1_cuda: l1_prog/l1_reg must be (L,), "
                         "out_l1 (Q,), the machine arrays (M,), the stream "
                         f"(R, T, {REG_SITES}) int8 and its counters "
                         f"(R, {NUM_SETS}, {len(REG_COUNTERS)})")
    if (min(host_prog) < 0 or max(host_prog) >= P or min(host_reg) < -1
            or max(host_reg) >= R or min(host_out) < 0
            or max(host_out) >= L):
        raise ValueError("engine_l1_cuda: a lane index is out of range")
    base = None if l1_base is None else _int32_on(l1_base, dev, "l1_base")
    if base is not None and base.shape != (L,):
        raise ValueError("engine_l1_cuda: l1_base must be (L,)")
    tiles = _tiles(T)
    n = L * l1_sets * tiles
    lane_slots = [host_len[p] * (SITES if r >= 0 else 2)
                  for p, r in zip(host_prog, host_reg)]
    slots = sum(lane_slots)
    tprog = _int32_on(sorted(set(host_prog)), dev, "programs")
    i32 = dict(dtype=torch.int32, device=dev)
    hist = torch.empty(n + 1, **i32)
    blocks = torch.empty(max(1, -(-n // SCAN_BLOCK)), **i32)
    recs = torch.empty((max(slots, 1), 2), **i32)
    outcome = torch.empty(max(slots, 1), dtype=torch.uint8, device=dev)
    l1sum = torch.empty((L, NUM_SETS, L1_SUMS), **i32)
    tsum = torch.empty((P, NUM_SETS, TRACE_SUMS), **i32)
    outs = [torch.zeros((Q, M, NUM_COUNTERS), **i32)
            for _ in range(NUM_SETS)]
    _launch(x, "engine_l1_launch", x.data_ptr(), P, T,
            *_ptrs(lengths, spill0s, stream.contiguous(),
                   reg_ctr.contiguous()), L, *_ptrs(prog, reg), Q,
            out_l1.data_ptr(), M, *_ptrs(*mach), l1_sets, l1_ways,
            int(bool(track_ab)), tprog.shape[0], tprog.data_ptr(), slots,
            *_ptrs(hist, blocks, recs, outcome, l1sum, tsum, *outs),
            None if base is None else base.data_ptr())
    engine_l1_cuda.count(dict(route="set"))
    if keep:
        return tuple(outs), dict(
            recs=recs, outcome=outcome, hist=hist, tiles=tiles,
            slots=np.cumsum([0] + lane_slots).tolist())
    return tuple(outs)


def engine_scan_cuda(x, spill0s, cfg, mach, *, l1_sets: int, l1_ways: int,
                     track_ab: bool = True, lengths=None):
    """K1 on a CUDA tensor ``x`` (P, T, NCOL) int32, the other inputs
    moved to x's card: :func:`engine_scan_plan`'s groups, each K1a
    (:func:`engine_reg_cuda`, where a config has capacity < 32) then K1b
    (:func:`engine_l1_cuda`).  Raises on what the kernels do not take and
    on a failed launch, before any launch where the inputs show it; never
    falls back."""
    x = _rows_on_card(x, "engine_scan_cuda")
    P, T, _ = x.shape
    dev = x.device
    lengths = _int32_on([T] * P if lengths is None else lengths, "cpu",
                        "lengths")
    spill0s = _int32_on(spill0s, dev, "spill0s")
    cfg = [_int32_on(a, "cpu", n) for a, n in zip(
        cfg, ("capacity", "policy", "alloc_no_fetch"))]
    mach = [_int32_on(a, dev, n) for a, n in zip(
        mach, ("l1_hit_cycles", "uop_hit_cycles", "mem_latency"))]
    C, M = cfg[0].shape[0], mach[0].shape[0]
    if (lengths.shape != (P,) or spill0s.shape != (P,)
            or any(a.shape != (C,) for a in cfg)
            or any(a.shape != (M,) for a in mach)):
        raise ValueError("engine_scan_cuda: lengths/spill0s must be (P,), "
                         "the config arrays (C,), the machine arrays (M,)")
    if int(lengths.min()) < 0 or int(lengths.max()) > T:
        raise ValueError(f"engine_scan_cuda: lengths must lie in [0, {T}]"
                         f", got {lengths.tolist()}")
    return _split_run(x, spill0s, cfg, mach, l1_sets=l1_sets,
                      l1_ways=l1_ways, track_ab=track_ab,
                      lengths=lengths.tolist(), reg_fn=engine_reg_cuda,
                      l1_fn=engine_l1_cuda)


def engine_scan(x, spill0s, cfg, mach, *, l1_sets: int, l1_ways: int,
                track_ab: bool = True, lengths=None):
    """The (P, C, M, 12) int32 counters ``(ctr, ctr_a, ctr_b)`` of the
    engine over ``x`` (P, T, NCOL) int32: the plain twin for a CPU x, K1
    for a CUDA x."""
    kw = dict(l1_sets=l1_sets, l1_ways=l1_ways, track_ab=track_ab,
              lengths=lengths)
    if x.is_cpu:
        return engine_scan_plain(x, spill0s, cfg, mach, **kw)
    if x.is_cuda:
        return engine_scan_cuda(x, spill0s, cfg, mach, **kw)
    raise ValueError(f"engine_scan runs on cpu or cuda, not {x.device}")
