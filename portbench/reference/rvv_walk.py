"""The plain walk: one RVV-lite program through a compact VRF and an L1,
row by row, in plain Python.

This is the benchmark's reference for the design-space sweep.  It reads
an unfolded instruction stream built by the frozen copy of the trace
layer (:mod:`portbench.reference.rvvtrace`), never the program's folded
traces, and gives the twelve counters of one (program, capacity, policy,
alloc_no_fetch, L1 geometry) point for every memory latency at once.

The machine, as the paper's engine defines it:

* each instruction's register operands are tag-checked in the order vs1,
  vs2, vd; ``v0`` is pinned and never checked.  A hit refreshes the
  slot's recency, frequency and next use (not its insertion order); a
  miss takes the first free slot, else evicts the operand-unlocked slot
  with the least metric (FIFO: insertion order, LRU: last use, LFU:
  ``min(freq, 511) * 2**21 + insertion order mod 2**21``, OPT: the
  farthest next use; ties to the lowest slot; slot 0 when nothing may be
  evicted).  A dirty victim is spilled to its reserved line, then the
  missing register is filled from its own, unless it is a vd that is
  wholly overwritten and ``alloc_no_fetch`` is on.  A full VRF (32
  registers) never misses;
* spills, fills and the vector loads and stores go through one L1: LRU
  within a set (the way with the least ``age << 1 | dirty`` word, a free
  way holding 0), write-allocate, write-back.  A hit costs the hit cycles
  of its class (``uop_hit_cycles`` for spills and fills,
  ``l1_hit_cycles`` for data), a miss one memory latency more, and a
  miss that writes back a dirty line two;
* time ``now`` is ``6 * row + site``: sites 0-2 are the register slots
  (a slot's spill and fill share its time), 3-4 the two data lanes.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.rvvtrace import isa

COUNTERS = ("cycles", "stall_cycles", "vrf_hits", "vrf_misses", "spills",
            "fills", "l1_hits", "l1_misses", "reg_reads", "reg_writes",
            "mem_reads", "mem_writes")
FIFO, LRU, LFU, OPT = 0, 1, 2, 3
NEVER = 2**31 - 8
LFU_FREQ_CAP = 511
LFU_SEQ_BITS = 21
LFU_SEQ_MASK = (1 << LFU_SEQ_BITS) - 1
INT_MAX = 2**31 - 1


def events(program) -> dict:
    """The per-row operands of ``program``, as numpy arrays."""
    tbl = isa.op_table()
    op = program.op
    vd, vs1, vs2 = program.vd, program.vs1, program.vs2
    T = op.shape[0]
    m = isa.MASK_REG
    valid = np.stack([
        tbl["reads_vs1"][op] & (vs1 >= 0) & (vs1 != m),
        tbl["reads_vs2"][op] & (vs2 >= 0) & (vs2 != m),
        (tbl["reads_vd"][op] | tbl["writes_vd"][op]) & (vd >= 0) & (vd != m),
    ], axis=1)
    reg = np.stack([vs1, vs2, vd], axis=1).astype(np.int64)
    is_load, is_store = tbl["is_load"][op], tbl["is_store"][op]
    is_mem = is_load | is_store
    nbytes = np.where((op == isa.VBCAST) | (op == isa.VSES), 4,
                      isa.VLEN_BYTES)
    addr = program.addr.astype(np.int64)
    line0 = addr >> 5
    line1 = (addr + nbytes - 1) >> 5
    mem_valid = np.stack([is_mem, is_mem & (line1 != line0)], axis=1)
    mem_line = np.stack([line0, line1], axis=1)
    cost = np.where(program.cost_override >= 0, program.cost_override,
                    tbl["cost"][op]).astype(np.int64)
    # Belady: each register slot's next use, as an index into the
    # row-major (T, 3) slot grid.
    flat = np.flatnonzero(valid.ravel())
    regs = reg.ravel()[flat]
    order = np.argsort(regs, kind="stable")
    nxt = np.full(T * 3, NEVER, np.int64)
    same = regs[order][:-1] == regs[order][1:]
    nxt[flat[order][:-1][same]] = flat[order][1:][same]
    return dict(
        valid=valid, reg=reg, nxt=nxt.reshape(T, 3),
        vd_write=tbl["writes_vd"][op] & valid[:, 2],
        vd_read=tbl["reads_vd"][op] & valid[:, 2],
        vd_nofetch=(tbl["full_overwrite"][op] & tbl["writes_vd"][op]
                    & ~tbl["reads_vd"][op] & valid[:, 2]),
        mem_valid=mem_valid, mem_line=mem_line,
        mem_write=mem_valid & is_store[:, None], cost=cost,
        spill_line0=(program.memory.nbytes + isa.VLEN_BYTES - 1)
        // isa.VLEN_BYTES + 4)


def walk_task(task: dict) -> dict:
    """:func:`walk` of one point named by plain values (a worker's task),
    the program built from the frozen copy at its size."""
    from portbench.reference import rvvtrace
    bench = rvvtrace.get_benchmark(task["program"])
    kp = task["kernel_params"]
    params = (bench.paper_params if kp == "paper" else
              bench.reduced_params if kp == "reduced" else kp)
    capacity, policy, anf = task["point"]
    return walk(events(bench.build(**params).program), capacity, policy,
                anf, task["l1_sets"], task["l1_ways"], task["mem_latency"],
                task["l1_hit_cycles"], task["uop_hit_cycles"])


def walk(ev: dict, capacity: int, policy: int, alloc_no_fetch: bool,
         l1_sets: int, l1_ways: int, mem_latency, l1_hit_cycles: int = 0,
         uop_hit_cycles: int = 1) -> dict:
    """The twelve counters of one point for each latency of
    ``mem_latency``: ``{counter: [value per latency]}``."""
    out = _outcomes(ev, int(capacity), int(policy), bool(alloc_no_fetch),
                    int(l1_sets), int(l1_ways))
    valid = ev["valid"]
    reads = int(valid[:, :2].sum() + ev["vd_read"].sum())
    writes = int(ev["vd_write"].sum())
    mem_reads = int((ev["mem_valid"] & ~ev["mem_write"]).sum())
    mem_writes = int(ev["mem_write"].sum())
    base = int(ev["cost"].sum())
    u_all, u_miss, u_wb = out["uop"]
    d_all, d_miss, d_wb = out["data"]
    res = {k: [] for k in COUNTERS}
    for lat in mem_latency:
        stall = uop_hit_cycles * u_all + lat * (u_miss + u_wb)
        data = l1_hit_cycles * d_all + lat * (d_miss + d_wb)
        for k, v in (("cycles", base + stall + data),
                     ("stall_cycles", stall), ("vrf_hits", out["hits"]),
                     ("vrf_misses", out["misses"]),
                     ("spills", out["spills"]), ("fills", out["fills"]),
                     ("l1_hits", u_all + d_all - u_miss - d_miss),
                     ("l1_misses", u_miss + d_miss), ("reg_reads", reads),
                     ("reg_writes", writes), ("mem_reads", mem_reads),
                     ("mem_writes", mem_writes)):
            res[k].append(int(v))
    return res


def _outcomes(ev, cap, pol, anf, sets, ways):
    """Walk the rows once: register hits, misses, spills and fills, and
    per L1 class (spill/fill uops, data) the accesses, the misses and the
    misses that wrote a dirty line back (counted in both)."""
    valid, mem_valid = ev["valid"], ev["mem_valid"]
    live = np.flatnonzero(valid.any(1) | mem_valid.any(1))
    full = cap >= isa.NUM_ARCH_VREGS
    hits = misses = spills = fills = 0
    u_all = u_miss = u_wb = 0
    d_all = d_miss = d_wb = 0

    l1_tag = [-1] * (sets * ways)
    l1_word = [0] * (sets * ways)

    def l1(line, write, now):
        """One L1 access: 0 hit, 1 miss, 2 miss with a write-back."""
        b = (line % sets) * ways
        tags = l1_tag[b:b + ways]
        if line in tags:
            p = b + tags.index(line)
            l1_word[p] = (l1_word[p] & 1) | write | (now << 1)
            return 0
        words = l1_word[b:b + ways]
        p = b + words.index(min(words))
        wb = l1_tag[p] >= 0 and l1_word[p] & 1
        l1_tag[p] = line
        l1_word[p] = write | (now << 1)
        return 2 if wb else 1

    rows = live.tolist()
    mv = mem_valid[live].tolist()
    ml = ev["mem_line"][live].tolist()
    mw = ev["mem_write"][live].tolist()
    if full:
        hits = int(valid.sum())
        for t, v, ln, w in zip(rows, mv, ml, mw):
            for m in (0, 1):
                if v[m]:
                    r = l1(ln[m], int(w[m]), 6 * t + 3 + m)
                    d_all += 1
                    d_miss += r > 0
                    d_wb += r == 2
        return dict(hits=hits, misses=0, spills=0, fills=0,
                    uop=(0, 0, 0), data=(d_all, d_miss, d_wb))

    sp0 = ev["spill_line0"]
    rv = valid[live].tolist()
    rg = ev["reg"][live].tolist()
    nx = ev["nxt"][live].tolist()
    vw = ev["vd_write"][live].tolist()
    vr = ev["vd_read"][live].tolist()
    vn = ev["vd_nofetch"][live].tolist()
    tag = [-1] * cap
    dirty = [0] * cap
    ins = [0] * cap
    last = [0] * cap
    freq = [0] * cap
    nextu = [0] * cap
    slot_of = {}
    seq = 0
    for i, t in enumerate(rows):
        now0 = 6 * t
        val, regs = rv[i], rg[i]
        lock_a = regs[0] if val[0] else -1
        lock_b = regs[1] if val[1] else -1
        for s in (0, 1, 2):
            if not val[s]:
                continue
            r = regs[s]
            now = now0 + s
            wr = int(vw[i]) if s == 2 else 0
            p = slot_of.get(r)
            if p is not None:
                hits += 1
                dirty[p] |= wr
                last[p] = now
                freq[p] += 1
                nextu[p] = nx[i][s]
                continue
            misses += 1
            if len(slot_of) < cap:
                p = tag.index(-1)
                evict = False
            else:
                la = lock_a if s >= 1 else -1
                lb = lock_b if s == 2 else -1
                p, best = 0, INT_MAX
                for j in range(cap):
                    tj = tag[j]
                    if tj == la or tj == lb:
                        continue
                    if pol == LRU:
                        mj = last[j]
                    elif pol == LFU:
                        mj = (min(freq[j], LFU_FREQ_CAP) << LFU_SEQ_BITS) + (
                            ins[j] & LFU_SEQ_MASK)
                    elif pol == OPT:
                        mj = -nextu[j]
                    else:
                        mj = ins[j]
                    if mj < best:
                        p, best = j, mj
                evict = True
            if evict:
                old = tag[p]
                if dirty[p]:
                    res = l1(sp0 + max(old, 0), 1, now)
                    spills += 1
                    u_all += 1
                    u_miss += res > 0
                    u_wb += res == 2
                del slot_of[old]
            if s != 2 or vr[i] or not (vn[i] and anf):
                res = l1(sp0 + max(r, 0), 0, now)
                fills += 1
                u_all += 1
                u_miss += res > 0
                u_wb += res == 2
            tag[p] = r
            slot_of[r] = p
            dirty[p] = wr
            ins[p] = seq
            last[p] = now
            freq[p] = 1
            nextu[p] = nx[i][s]
            seq += 1
        v = mv[i]
        if v[0] or v[1]:
            ln, w = ml[i], mw[i]
            for m in (0, 1):
                if v[m]:
                    res = l1(ln[m], int(w[m]), now0 + 3 + m)
                    d_all += 1
                    d_miss += res > 0
                    d_wb += res == 2
    return dict(hits=hits, misses=misses, spills=spills, fills=fills,
                uop=(u_all, u_miss, u_wb), data=(d_all, d_miss, d_wb))
