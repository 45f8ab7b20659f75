"""Dispersed KV cache: the paper's Register Dispersion mechanism applied to
serving-time KV pages.

Mapping of the paper's concepts:

  architectural vector registers  ->  logical KV pages (page_size tokens)
  compact VRF (cVRF)              ->  hot page pool in fast memory
  reserved per-register address   ->  each logical page's fixed slot in the
                                      cold (overflow) region
  v0 pinned                       ->  attention-sink pages pinned hot
  FIFO replacement                ->  same policies module as the cVRF

The pool controller is host-side (numpy metadata, the same victim choice as
the cycle engine's oracle, ``core.policies.np_select_victim``); the page
contents ``hot`` and ``cold`` are device tensors.  Where the reference
rebuilds an array with ``.at[].set``, this module assigns in place into
``hot`` or ``cold``, and says so at each site.

Beyond the paper, the pool is a *live-degradable* resource: ``shrink()``
reduces the hot capacity mid-service, and ``pin``/``unpin``/``evict``/
``release`` give the serving engine explicit page lifetime control.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import policies
from repro_torch.models.common import DTYPES, resolve_device


@dataclasses.dataclass
class PagePoolConfig:
    num_logical_pages: int          # "architectural registers"
    num_hot_pages: int              # "compact VRF" capacity
    page_shape: tuple               # per-page array shape, e.g. (P, Hkv, D)
    policy: int = policies.FIFO
    pin_first: int = 1              # attention sinks (the v0 analogue)
    dtype: str = "bfloat16"


class DispersedKVPool:
    """Hot pool + cold overflow, FIFO/LRU/LFU/OPT-policied."""

    def __init__(self, cfg: PagePoolConfig, device="cuda"):
        if cfg.num_hot_pages < 2 + cfg.pin_first:
            raise ValueError(
                f"num_hot_pages={cfg.num_hot_pages} leaves fewer than two "
                f"evictable slots beside {cfg.pin_first} pinned")
        self.cfg = cfg
        dev = resolve_device(device)
        dt = DTYPES[cfg.dtype]
        self.hot = torch.zeros((cfg.num_hot_pages,) + tuple(cfg.page_shape),
                               dtype=dt, device=dev)
        self.cold = torch.zeros(
            (cfg.num_logical_pages,) + tuple(cfg.page_shape), dtype=dt,
            device=dev)
        n = cfg.num_hot_pages
        self.tags = np.full(n, -1, np.int64)
        self.dirty = np.zeros(n, bool)
        self.ins_seq = np.zeros(n, np.int64)
        self.last_use = np.zeros(n, np.int64)
        self.freq = np.zeros(n, np.int64)
        self.next_use = np.zeros(n, np.int64)
        self.pinned = np.zeros(n, bool)
        self._pin_set: set[int] = set(range(cfg.pin_first))
        self._seq = 0
        self._now = 0
        self.reset_stats()

    # ------------------------------------------------------------- cache --
    def _slot_of(self, page: int) -> int | None:
        w = np.nonzero(self.tags == page)[0]
        return int(w[0]) if w.size else None

    def _spill(self, s: int) -> None:
        self.cold[int(self.tags[s])] = self.hot[s]        # in place
        self.spills += 1

    def acquire(self, page: int, *, write: bool) -> int:
        """Make logical ``page`` hot; returns its hot-slot index."""
        if not 0 <= page < self.cfg.num_logical_pages:
            raise IndexError(f"page {page} outside "
                             f"[0, {self.cfg.num_logical_pages})")
        self._now += 1
        s = self._slot_of(page)
        if s is not None:
            self.hits += 1
            self.last_use[s] = self._now
            self.freq[s] += 1
            self.dirty[s] |= write
            return s
        self.misses += 1
        free = np.nonzero(self.tags < 0)[0]
        if free.size:
            s = int(free[0])
        else:
            s = policies.np_select_victim(
                self.tags, self.ins_seq, self.last_use, self.freq,
                self.next_use, self.pinned, self.cfg.num_hot_pages,
                self.cfg.policy)
            if self.dirty[s]:
                self._spill(s)
        self.hot[s] = self.cold[page]                     # in place (fill)
        self.fills += 1
        self.tags[s] = page
        self.dirty[s] = write
        self._seq += 1
        self.ins_seq[s] = self._seq
        self.last_use[s] = self._now
        self.freq[s] = 1
        self.pinned[s] = page in self._pin_set
        return s

    def read(self, page: int) -> torch.Tensor:
        """A copy of ``page``'s contents (the hot slot may be refilled
        later, so no view of it is handed out)."""
        s = self.acquire(page, write=False)
        return self.hot[s].clone()

    def write(self, page: int, value) -> None:
        s = self.acquire(page, write=True)
        self.hot[s] = value.to(self.hot.dtype)            # in place

    def flush(self) -> torch.Tensor:
        """Spill everything; returns the full logical tensor (cold view).
        Idempotent: a second flush with no intervening writes is a no-op."""
        for s in range(self.cfg.num_hot_pages):
            if self.tags[s] >= 0 and self.dirty[s]:
                self.cold[int(self.tags[s])] = self.hot[s]    # in place
                self.dirty[s] = False
        return self.cold

    # ----------------------------------------------------- page lifetime --
    def pin(self, page: int) -> None:
        """Pin ``page`` hot from now on (the per-sequence attention-sink
        analogue of the paper's v0).  The pool refuses to pin its whole
        capacity: at least two slots must stay evictable."""
        if page in self._pin_set:
            return
        if len(self._pin_set) >= self.cfg.num_hot_pages - 2:
            raise ValueError(
                f"cannot pin page {page}: {len(self._pin_set)} of "
                f"{self.cfg.num_hot_pages} hot slots already pinned "
                "(two must stay evictable)")
        self._pin_set.add(page)
        s = self._slot_of(page)
        if s is not None:
            self.pinned[s] = True

    def unpin(self, page: int) -> None:
        self._pin_set.discard(page)
        s = self._slot_of(page)
        if s is not None:
            self.pinned[s] = False

    def evict(self, page: int) -> None:
        """Force ``page`` out of the hot pool (writeback to cold if dirty).
        The cold copy stays valid — this is the preemption spill path."""
        s = self._slot_of(page)
        if s is None:
            return
        if self.dirty[s]:
            self._spill(s)
        self._drop_slot(s)

    def release(self, page: int) -> None:
        """Discard ``page`` entirely (no writeback): its hot slot is freed
        and the cold copy is considered garbage — completion/abort path."""
        self.unpin(page)
        s = self._slot_of(page)
        if s is not None:
            self._drop_slot(s)

    def _drop_slot(self, s: int) -> None:
        self.tags[s] = -1
        self.dirty[s] = False
        self.pinned[s] = False
        self.ins_seq[s] = self.last_use[s] = 0
        self.freq[s] = self.next_use[s] = 0

    # -------------------------------------------------- graceful shrink --
    def shrink(self, new_hot_pages: int) -> int:
        """Shrink the hot pool *live* to ``new_hot_pages`` slots: victims
        are selected by the configured replacement policy (pinned pages
        survive), dirty victims are spilled to cold, and service continues
        from the smaller pool.  Returns the number of pages spilled."""
        n = self.cfg.num_hot_pages
        if new_hot_pages >= n:
            return 0
        if new_hot_pages < max(2 + len(self._pin_set), 2):
            raise ValueError(
                f"cannot shrink hot pool to {new_hot_pages}: "
                f"{len(self._pin_set)} pinned pages + 2 evictable slots "
                "must fit")
        drop: list[int] = []
        spilled = 0
        for _ in range(n - new_hot_pages):
            # Prefer free slots; otherwise the policy picks the victim
            # among slots not already scheduled for removal.
            tags = self.tags.copy()
            tags[drop] = -2                       # poison: neither free
            pinned = self.pinned.copy()           # nor evictable
            pinned[drop] = True
            free = np.nonzero(tags == -1)[0]
            if free.size:
                drop.append(int(free[0]))
                continue
            s = policies.np_select_victim(
                tags, self.ins_seq, self.last_use, self.freq,
                self.next_use, pinned, n, self.cfg.policy)
            if self.dirty[s]:
                self._spill(s)
                spilled += 1
            drop.append(s)
        keep = np.asarray([i for i in range(n) if i not in set(drop)],
                          np.int64)
        self.hot = self.hot[torch.from_numpy(keep).to(self.hot.device)]
        for name in ("tags", "dirty", "ins_seq", "last_use", "freq",
                     "next_use", "pinned"):
            setattr(self, name, getattr(self, name)[keep])
        self.cfg.num_hot_pages = new_hot_pages
        self.shrinks += 1
        return spilled

    # --------------------------------------------------------- accounting --
    def reset_stats(self) -> None:
        """Zero the access counters (hits/misses/spills/fills/shrinks);
        cache *contents* are untouched."""
        self.hits = self.misses = self.spills = self.fills = 0
        self.shrinks = 0

    def stats(self) -> dict:
        total = self.hits + self.misses
        return dict(hits=self.hits, misses=self.misses,
                    hit_rate=self.hits / max(total, 1), spills=self.spills,
                    fills=self.fills, shrinks=self.shrinks,
                    hot_pages=int(self.cfg.num_hot_pages),
                    pinned_pages=len(self._pin_set),
                    hot_bytes=self.hot.numel() * self.hot.element_size(),
                    cold_bytes=self.cold.numel() * self.cold.element_size())
