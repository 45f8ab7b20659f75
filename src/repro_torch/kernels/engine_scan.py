"""The engine scan (K1): the CUDA kernel, its wrapper and the plain twin.

Port of the reference's cycle engine, ``repro/core/simulator.py``
``_run_grid`` (a ``lax.scan`` of ``_make_step``/``_make_body`` under three
``vmap``s, with ``_l1_access`` and the policies of ``core/policies.py``).
XLA compiles it from a scan body, so it has no ``pallas_call``; on Hopper
it is a hand-written kernel, ``csrc/engine_scan.cu``, which also says
what bounds it (one lane is a serial chain of rows) and how it is laid
out (one warp per lane, the cVRF's 32 slots on the warp's 32 threads, the
lane's L1 in shared memory).

Inputs: the 15 event arrays of ``simulator._stack`` packed by :func:`pack`
into one (P, T, ``NCOL``) int32 tensor (columns in :data:`COLUMNS`
order), the per-program spill bases and row counts, the config axis
(capacity, policy, alloc_no_fetch; (C,) each) and the machine axis (L1
hit, uop hit, memory latency; (M,) each), with the static L1 geometry.
Output: the (P, C, M, 12) int32 counters (order
``simulator.COUNTER_NAMES``) weighted by ``wt``, and the measured periods
A and B weighted by ``wa``/``wb`` (zeros unless ``track_ab``).

A CPU tensor goes to :func:`engine_scan_plain`, a CUDA tensor to
:func:`engine_scan_cuda`, which launches the kernel or raises; there is no
fallback.  ``engine_scan_cuda`` counts its launches (one route, ``warp``:
one warp per lane).
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

# The kernel's tile (csrc/engine_scan.cu): lanes (warps) per CTA, rows a
# warp stages in shared memory at a time.
WARPS_PER_CTA = 4
CHUNK_ROWS = 32
MAX_SMEM_BYTES = 232448


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
                      l1_ways: int, track_ab: bool = True, lengths=None):
    """The engine in plain torch: the reference's ``_make_step`` /
    ``_make_body`` with the P x C x M lanes flattened onto one batch
    dimension, one Python iteration per instruction row.  The CPU path
    and the kernel's oracle; it costs one to a few milliseconds a row on
    a CPU, so it serves reduced-size traces.  Returns ``(ctr, ctr_a, ctr_b)``,
    (P, C, M, 12) int32 each.

    Its tensors are a few thousand elements, too small to share among
    threads, so it runs with one intra-op thread: torch's other threads
    would otherwise spin between its operations on every idle core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _scan_rows(x, spill0s, cfg, mach, l1_sets=l1_sets,
                          l1_ways=l1_ways, track_ab=track_ab,
                          lengths=lengths)
    finally:
        torch.set_num_threads(threads)


def _scan_rows(x, spill0s, cfg, mach, *, l1_sets, l1_ways, track_ab,
               lengths):
    P, T, ncol = x.shape
    if ncol != NCOL:
        raise ValueError(f"x has {ncol} columns, want {NCOL}")
    dev = x.device
    (p_of, cap, pol, anf, hit_d, hit_u, lat, C, M) = _grid_lanes(
        P, cfg, mach, dev)
    B = P * C * M
    sp0 = torch.as_tensor(spill0s, dtype=torch.int32, device=dev)[p_of]
    walk = T if lengths is None else int(max(lengths, default=0))
    full = cap >= NUM_ARCH_VREGS
    nfull = ~full
    valid = torch.arange(NUM_ARCH_VREGS, device=dev)[None, :] < cap[:, None]
    lanes = torch.arange(B, device=dev)
    cache = policies.CacheState.init(NUM_ARCH_VREGS, B, dev)
    l1 = l1_init(B, l1_sets, l1_ways, dev)
    seq = torch.zeros(B, dtype=torch.int32, device=dev)
    ctr = torch.zeros((B, NUM_COUNTERS), dtype=torch.int32, device=dev)
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
                for do, line, is_w, ctr_k in (
                        (do_spill, vrow[:, policies.TAG], True, SPILLS),
                        (do_fill, rg, False, FILLS)):
                    if bool(do.any()):
                        c, h = l1_access(l1, sp0 + line.clamp(min=0), is_w,
                                         now, do, hit_u, lat)
                        cyc += [(CYCLES, c), (STALL, c)]
                        flags += [(ctr_k, do), (L1_HITS, do & h),
                                  (L1_MISSES, do & ~h)]
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
            c, h = l1_access(l1, xr[ML + m], is_w, _i32(now0 + 3 + m),
                             active, hit_d, lat)
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
        ctr += inc * xr[WT][:, None]
        if track_ab:
            ctr_a += inc * xr[WA][:, None]
            ctr_b += inc * xr[WB][:, None]
    shape = (P, C, M, NUM_COUNTERS)
    return ctr.view(shape), ctr_a.view(shape), ctr_b.view(shape)


# The C entry points' parameters (csrc/engine_scan.cu).
ARGTYPES = {
    "engine_scan_launch": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
                           + [ctypes.c_void_p] * 5 + [ctypes.c_int]
                           + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p] * 4),
    "engine_scan_tile": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}
TILE_KEYS = ("warps_per_cta", "chunk_rows", "ncol", "smem_bytes")


def engine_scan_plan(l1_sets: int, l1_ways: int) -> dict:
    """The tile the CUDA kernel takes for an L1 of ``l1_sets`` x
    ``l1_ways``: the :data:`TILE_KEYS` figures and the route.  Raises
    ``ValueError`` for a geometry the kernel does not take (ways outside
    1..32: thread w of the warp holds way w; or a shared-memory stage past
    the CTA's limit)."""
    smem = WARPS_PER_CTA * (CHUNK_ROWS * NCOL + 2 * l1_sets * l1_ways) * 4
    if l1_sets < 1 or not 1 <= l1_ways <= 32 or smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"engine_scan takes 1..32 ways and at most {MAX_SMEM_BYTES} "
            f"bytes of shared memory, got {l1_sets} sets x {l1_ways} ways "
            f"({smem} bytes)")
    return dict(route="warp", warps_per_cta=WARPS_PER_CTA,
                chunk_rows=CHUNK_ROWS, ncol=NCOL, smem_bytes=smem)


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
    """The built kernel's tile for an L1 geometry (``engine_scan_tile``):
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


@RouteCounted.over("warp")
def engine_scan_cuda(x, spill0s, cfg, mach, *, l1_sets: int, l1_ways: int,
                     track_ab: bool = True, lengths=None):
    """Launch K1 on a CUDA tensor ``x`` (P, T, NCOL) int32; the other
    inputs are moved to x's card.  Raises on what the kernel does not take
    and on a failed launch; never falls back."""
    if not x.is_cuda:
        raise ValueError(f"engine_scan_cuda needs x on a CUDA device, got "
                         f"{x.device}")
    if (x.dtype != torch.int32 or x.dim() != 3 or x.shape[2] != NCOL
            or x.shape[0] == 0):
        raise ValueError(f"engine_scan_cuda needs x (P, T, {NCOL}) int32, "
                         f"got {tuple(x.shape)} {x.dtype}")
    x = x.contiguous()
    plan = engine_scan_plan(l1_sets, l1_ways)
    P, T, _ = x.shape
    dev = x.device
    lengths = _int32_on([T] * P if lengths is None else lengths, "cpu",
                        "lengths")
    spill0s = _int32_on(spill0s, dev, "spill0s")
    cfg = [_int32_on(a, dev, n) for a, n in zip(
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
    lengths = lengths.to(dev)
    outs = [torch.zeros((P, C, M, NUM_COUNTERS), dtype=torch.int32,
                        device=dev) for _ in range(3)]
    lib = _library()
    ctx = (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
           else torch.cuda.device(dev))
    with ctx:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.engine_scan_launch(
            x.data_ptr(), P, T, lengths.data_ptr(), spill0s.data_ptr(),
            *(a.data_ptr() for a in cfg), C,
            *(a.data_ptr() for a in mach), M, l1_sets, l1_ways,
            int(bool(track_ab)), *(o.data_ptr() for o in outs), stream)
    if err == -1:
        raise ValueError(f"engine_scan: the kernel refused {plan}")
    if err:
        raise RuntimeError(f"engine_scan launch failed: cudaError {err}")
    engine_scan_cuda.count(plan)
    return tuple(outs)


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
