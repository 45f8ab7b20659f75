"""Replacement policies for compact register files / dispersed caches.

The paper's cVRF uses FIFO replacement ("evict the register at the head
pointer", §3.2.2).  FIFO is implemented faithfully, with LRU, LFU-lite and
offline-optimal (Belady/OPT) as beyond-paper headroom analyses.  The same
victim choice drives the cycle engine (register granularity) and the
serving layer's dispersed KV cache (page granularity).

Layout: all per-slot metadata lives in ONE ``(lanes, n_slots, 7)`` int32
tensor (column constants below), so the engine updates a slot with one
7-wide row write per operand.  The torch functions take a leading lane
dimension: a batch of (program, config, machine) lanes of the engine's
grid, each with its own cache.  Ties go to the lowest slot index
everywhere (``argmax``/``argmin`` return the first extremum), which
decides counters: every never-reused slot holds ``NO_NEXT_USE`` under OPT,
and with no evictable slot the victim is slot 0.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

FIFO = 0      # paper's policy: evict longest-resident entry
LRU = 1       # evict least-recently-used
LFU = 2       # evict least-frequently-used (ties -> oldest)
OPT = 3       # Belady: evict entry with the farthest next use (offline)

POLICY_NAMES = {FIFO: "fifo", LRU: "lru", LFU: "lfu", OPT: "opt"}

INT_MAX = 2**31 - 1
NO_NEXT_USE = 2**31 - 8   # "never used again" sentinel (fits int32)

# Columns of CacheState.meta.
TAG = 0        # architectural id cached in the slot (-1 = free)
DIRTY = 1      # modified since fill (0/1)
INS_SEQ = 2    # insertion order   (FIFO)
LAST_USE = 3   # last access order (LRU)
FREQ = 4       # access count      (LFU)
NEXT_USE = 5   # next future use   (OPT)
PINNED = 6     # never evict (v0-analogue entries; 0/1)
NUM_COLS = 7

# LFU-lite's packed metric: min(freq, LFU_FREQ_CAP) in the high bits,
# insertion order modulo 2^LFU_SEQ_BITS in the low ones.  Past 2^21 misses
# the wrapped order differs from np_select_victim's (freq, ins_seq) tuple;
# the engine follows the packed metric.
LFU_FREQ_CAP = 511
LFU_SEQ_BITS = 21


@dataclasses.dataclass
class CacheState:
    """Per-slot metadata of a batch of lanes, carried through the engine's
    instruction loop."""

    meta: torch.Tensor        # (lanes, n_slots, NUM_COLS) int32

    @staticmethod
    def init(n_slots: int, lanes: int = 1, device="cpu") -> "CacheState":
        meta = torch.zeros((lanes, n_slots, NUM_COLS), dtype=torch.int32,
                           device=device)
        meta[:, :, TAG] = -1
        return CacheState(meta=meta)

    @property
    def tags(self) -> torch.Tensor:
        return self.meta[:, :, TAG]

    @property
    def dirty(self) -> torch.Tensor:
        return self.meta[:, :, DIRTY] == 1


@functools.cache
def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)


def _column(x):
    """A per-lane tensor as a (lanes, 1) column broadcasting over the
    slots; a Python int stays a scalar."""
    return x.unsqueeze(1) if isinstance(x, torch.Tensor) else x


def select_victim(state: CacheState, policy, valid_mask, lock_a=-1,
                  lock_b=-1) -> torch.Tensor:
    """(lanes,) index of the slot to evict among occupied, unpinned,
    in-capacity slots whose tag is neither ``lock_a`` nor ``lock_b`` (the
    operands of the in-flight instruction already tag-checked), smallest
    metric first.  ``policy`` is one FIFO/LRU/LFU/OPT code per lane (any
    other code means FIFO).  With no such slot every metric is
    ``INT_MAX`` and the first slot, 0, wins."""
    m = state.meta
    tags = m[:, :, TAG]
    occ = ((tags >= 0) & valid_mask & (m[:, :, PINNED] == 0)
           & (tags != _column(lock_a)) & (tags != _column(lock_b)))
    lfu = (m[:, :, FREQ].clamp(max=LFU_FREQ_CAP) * (1 << LFU_SEQ_BITS)
           + (m[:, :, INS_SEQ] & ((1 << LFU_SEQ_BITS) - 1)))
    pol = torch.as_tensor(policy, device=m.device)
    pol = pol.reshape(-1, 1) if pol.dim() else pol
    metric = torch.where(pol == LRU, m[:, :, LAST_USE], m[:, :, INS_SEQ])
    metric = torch.where(pol == LFU, lfu, metric)
    metric = torch.where(pol == OPT, -m[:, :, NEXT_USE], metric)
    return torch.argmin(torch.where(occ, metric, INT_MAX), dim=1)


def apply_access(state: CacheState, *, active, raw_hit, hit_slot,
                 install_slot, tag, now, seq, next_use, is_write,
                 pinned=False) -> CacheState:
    """Metadata update for one (possibly masked-off) REG access per lane.

    A hit refreshes recency, frequency and next use (FIFO deliberately
    does NOT refresh the insertion order on hits — paper §3.2.2: the
    circular FIFO head is the longest-*resident* entry); a miss installs
    the tag at ``install_slot``.  One 7-wide row write at the hit-or-install
    slot, gated by ``active``.  The per-lane arguments are (lanes,)
    tensors or Python scalars.  Updates ``state`` in place (the engine
    owns it) and returns it."""
    m = state.meta
    lanes = _arange(m.shape[0], m.device)
    tgt = torch.where(raw_hit, hit_slot, install_slot)
    old = m[lanes, tgt]
    new = torch.empty_like(old)
    new[:, TAG] = torch.where(raw_hit, old[:, TAG], tag)
    new[:, DIRTY] = torch.where(raw_hit, old[:, DIRTY] | is_write, is_write)
    new[:, INS_SEQ] = torch.where(raw_hit, old[:, INS_SEQ], seq)
    new[:, LAST_USE] = now
    new[:, FREQ] = torch.where(raw_hit, old[:, FREQ] + 1, 1)
    new[:, NEXT_USE] = next_use
    new[:, PINNED] = torch.where(raw_hit, old[:, PINNED], int(pinned))
    m[lanes, tgt] = torch.where(_column(active), new, old)
    return state


def lookup(state: CacheState, tag, valid_mask):
    """(hit, slot) per lane for ``tag``; slot is the first match, or 0."""
    eq = (state.meta[:, :, TAG] == _column(tag)) & valid_mask
    return eq.max(dim=1)


def free_slot(state: CacheState, valid_mask):
    """(has_free, slot) per lane: the first unoccupied in-capacity slot."""
    return ((state.meta[:, :, TAG] < 0) & valid_mask).max(dim=1)


# ------------------------------------------------------------------ numpy --
# Reference (oracle) implementation used by the numpy interpreter and the
# KV pool.  Kept deliberately simple and independent of the torch versions
# above.

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
