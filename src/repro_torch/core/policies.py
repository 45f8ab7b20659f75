"""Replacement policies for compact register files / dispersed caches.

The paper's cVRF uses FIFO replacement ("evict the register at the head
pointer", §3.2.2).  FIFO is implemented faithfully, with LRU, LFU-lite and
offline-optimal (Belady/OPT) as beyond-paper headroom analyses.  The same
victim choice drives the serving layer's dispersed KV cache (page
granularity).

This module holds the policy constants and the numpy victim oracle that the
KV pool uses; the engine's per-slot metadata layout and its device-side
twin belong to the cycle engine, which is not part of this package yet.
"""

from __future__ import annotations

FIFO = 0      # paper's policy: evict longest-resident entry
LRU = 1       # evict least-recently-used
LFU = 2       # evict least-frequently-used (ties -> oldest)
OPT = 3       # Belady: evict entry with the farthest next use (offline)

POLICY_NAMES = {FIFO: "fifo", LRU: "lru", LFU: "lfu", OPT: "opt"}


def np_select_victim(tags, ins_seq, last_use, freq, next_use, pinned,
                     capacity, policy, locked=()) -> int:
    """Index of the slot to evict among occupied, unpinned, unlocked slots
    ``< capacity``; ties go to the lowest index."""
    best, best_m = -1, None
    for i in range(capacity):
        if tags[i] < 0 or pinned[i] or tags[i] in locked:
            continue
        m = {FIFO: ins_seq[i], LRU: last_use[i],
             LFU: (freq[i], ins_seq[i]), OPT: -next_use[i]}[policy]
        if best_m is None or m < best_m:
            best, best_m = i, m
    if best < 0:
        raise ValueError("no evictable slot")
    return best
