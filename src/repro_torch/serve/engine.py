"""Batched serving engine with a robustness control plane.

The engine drives ``Model.decode_step`` (eager) over a fixed slot grid;
finished requests free their slot for the next queued request (continuous
batching).  Prompts are consumed by decode, one token per step, as in the
reference.  On top of the decode loop it carries:

  * **admission control** — a bounded queue with backpressure: arrivals
    beyond ``max_queue`` are rejected, and a request is only bound to a
    slot when the KV page budget can host it;
  * **deadlines + retry** — per-request decode deadlines (virtual ticks per
    attempt); a timed-out attempt is torn down and retried under a bounded
    exponential backoff until the retry budget fails it;
  * **preemption** — a victim sequence's KV is spilled to cold (through
    :class:`DispersedKVPool` in ``kv_mode='dispersed'``, to host memory
    otherwise) and the request re-admitted later **bit-identically**;
  * **fault detection** — per-slot :class:`Heartbeat` records on the
    virtual clock feed a median-based :class:`StragglerPolicy`; a slot
    frozen by an injected fault accumulates strikes until the engine
    evicts (preempts) it;
  * **graceful degradation** — ``kv_mode='dispersed'`` pages each
    sequence's KV through a :class:`DispersedKVPool`; pool misses cost
    virtual time (``fill_ticks``), so a smaller hot pool degrades latency
    instead of failing.

All timing is virtual (:class:`repro_torch.serve.traffic.VirtualClock`):
a run is a pure function of (scenario, fault profile, seed).

``Model.decode_step`` updates the KV cache in place, so every slice the
engine keeps across a decode (rollback of a frozen slot, the host snapshot
of a preempted one) is a copy.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.core import policies
from repro_torch.device import resolve_device
from repro_torch.runtime.fault_tolerance import (Heartbeat, RestartPolicy,
                                                 StragglerPolicy)
from repro_torch.serve.chaos import FaultInjector, FaultProfile
from repro_torch.serve.kvcache import DispersedKVPool, PagePoolConfig
from repro_torch.serve.traffic import Scenario, VirtualClock

# Request lifecycle states.
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
REJECTED = "rejected"
FAILED = "failed"
PREEMPTED = "preempted"


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 16
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # --- robustness control plane -------------------------------------
    rid: int = -1                     # engine-assigned if negative
    tenant: str = ""
    arrival_t: float = 0.0            # virtual ticks
    deadline: float | None = None     # ticks per attempt; None = best-effort
    status: str = QUEUED
    retries: int = 0
    preemptions: int = 0
    admit_t: float | None = None      # first admission to a slot
    first_token_t: float | None = None
    finish_t: float | None = None
    token_times: list[float] = dataclasses.field(default_factory=list)


class ServeEngine:
    """Continuous-batching decode engine over ``slots`` sequences.

    ``model`` is a :class:`repro_torch.models.Model` holding the weights;
    it must live on ``device``.  ``decode_fn(cache, batch) -> (logits,
    cache)`` defaults to ``model.decode_step``.

    ``kv_mode='resident'`` keeps KV fully resident; ``kv_mode='dispersed'``
    pages it through a :class:`DispersedKVPool` whose hot capacity
    (``hot_pages``) bounds fast-memory use — pool fills and spills cost
    ``fill_ticks`` of virtual time each.  (The reference also takes a
    ``spill_ticks`` that nothing reads; the port has none.)
    """

    STALL_FACTOR = 6.0    # heartbeat inflation of a frozen (failing) slot

    def __init__(self, cfg, model, *, slots: int = 4, max_len: int = 256,
                 temperature: float = 0.0, seed: int = 0,
                 kv_mode: str = "resident", page_size: int = 16,
                 hot_pages: int | None = None, cold_pages: int | None = None,
                 pool_policy: int = policies.FIFO,
                 max_queue: int = 64, base_step_ticks: float = 1.0,
                 fill_ticks: float = 0.05,
                 max_retries: int = 3, backoff_base: float = 2.0,
                 backoff_cap: float = 32.0,
                 straggler: StragglerPolicy | None = None,
                 clock: VirtualClock | None = None,
                 decode_fn=None, device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine asked "
                             f"for {self.device}")
        self.cfg = cfg
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.temperature = temperature
        self.gen = torch.Generator().manual_seed(seed)   # host-side sampling
        self.cache = self.model.init_cache(slots, max_len)
        self.pos = np.zeros(slots, np.int64)
        self.active: list[Request | None] = [None] * slots
        self._decode = decode_fn if decode_fn is not None \
            else self.model.decode_step

        # -- virtual time + detection machinery --------------------------
        self.clock = clock if clock is not None else VirtualClock()
        self.base_step_ticks = base_step_ticks
        self.fill_ticks = fill_ticks
        self.straggler = straggler if straggler is not None else \
            StragglerPolicy(threshold=2.5, strikes_to_evict=2,
                            window=4 * slots)
        self._heartbeats = [Heartbeat(host_id=s) for s in range(slots)]
        self._recs: list = []
        self.failing_until = np.zeros(slots, np.float64)
        self.chaos: FaultInjector | None = None

        # -- admission control -------------------------------------------
        self.max_queue = max_queue
        self.queue: collections.deque = collections.deque()  # of dict rows
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self._retry: dict[int, RestartPolicy] = {}
        self._suspended: dict[int, dict] = {}     # rid -> preempted state
        self._next_rid = 0

        # -- counters + telemetry ------------------------------------------
        self.rejected = 0
        self.preemptions = 0
        self.deadline_misses = 0
        self.timeouts = 0
        self.step_log: list[dict] = []
        self._step_no = 0

        # -- dispersed KV pool ---------------------------------------------
        self.kv_mode = kv_mode
        self.pool: DispersedKVPool | None = None
        if kv_mode == "dispersed":
            self._init_pool(page_size, hot_pages, cold_pages, pool_policy)
        elif kv_mode != "resident":
            raise ValueError(
                f"kv_mode must be 'resident' or 'dispersed', got {kv_mode!r}")

    # ------------------------------------------------------------- pool --
    def _init_pool(self, page_size, hot_pages, cold_pages, pool_policy):
        cfg = self.cfg
        if self.max_len % page_size:
            raise ValueError(
                f"page_size {page_size} must divide max_len {self.max_len}")
        self.page_size = page_size
        self._pages_per_seq = self.max_len // page_size
        self._paged = ("k", "v")
        self._unpaged = tuple(k for k in self.cache if k not in self._paged)
        self._page_block = {
            k: (self.cache[k].shape[0], page_size)
            + tuple(self.cache[k].shape[3:]) for k in self._paged}
        flat = sum(int(np.prod(b)) for b in self._page_block.values())
        hot = hot_pages if hot_pages is not None \
            else max(self.slots + 2, self._pages_per_seq)
        if hot < self.slots + 2:
            raise ValueError(
                f"hot_pages={hot} too small: one pinned sink per slot plus "
                f"two evictable slots need >= {self.slots + 2}")
        cold = cold_pages if cold_pages is not None \
            else max(4 * self.slots, 8) * self._pages_per_seq
        self.pool = DispersedKVPool(PagePoolConfig(
            num_logical_pages=cold, num_hot_pages=hot, page_shape=(flat,),
            policy=pool_policy, pin_first=0, dtype=cfg.dtype),
            device=self.device)
        self._free_pages: collections.deque = collections.deque(range(cold))
        self._page_table: dict[int, list[int]] = {}
        self._pool_ops_seen = 0

    def _pack_page(self, s: int, pg: int) -> torch.Tensor:
        lo, hi = pg * self.page_size, (pg + 1) * self.page_size
        return torch.cat(
            [self.cache[k][:, s, lo:hi].reshape(-1) for k in self._paged])

    def _unpack_page(self, s: int, pg: int, flat: torch.Tensor) -> None:
        lo, hi = pg * self.page_size, (pg + 1) * self.page_size
        off = 0
        for k in self._paged:
            block = self._page_block[k]
            n = int(np.prod(block))
            part = flat[off:off + n].reshape(block)
            self.cache[k][:, s, lo:hi] = part               # in place
            off += n

    def _used_pages(self, s: int) -> int:
        p = int(self.pos[s])
        return 0 if p <= 0 else (p - 1) // self.page_size + 1

    def _account_dispersed(self, s: int, req: Request) -> None:
        """Feed this step's access pattern through the pool: attention
        reads every history page (dense decode truth), the tail page takes
        this step's KV bytes (write-through)."""
        table = self._page_table[req.rid]
        pg = (int(self.pos[s]) - 1) // self.page_size
        for p in range(pg):
            self.pool.acquire(table[p], write=False)
        self.pool.write(table[pg], self._pack_page(s, pg))

    def kv_stats(self) -> dict:
        return self.pool.stats() if self.pool else {}

    # ------------------------------------------------------------ intake --
    def _reset_slot(self, s: int) -> None:
        """Zero slot ``s`` across all cache tensors."""
        for v in self.cache.values():
            v[:, s] = 0                                     # in place

    def _validate(self, req: Request) -> None:
        if not req.prompt:
            raise ValueError(
                "empty prompt: a Request(prompt=[]) has no token to feed "
                "the decoder (the engine would loop on token 0 forever); "
                "prefill at least one token (e.g. a BOS id)")
        if req.rid < 0:
            req.rid = self._next_rid
            self._next_rid += 1
        else:
            self._next_rid = max(self._next_rid, req.rid + 1)

    def submit(self, req: Request) -> bool:
        """Direct admission: bind ``req`` to a free slot now.  Returns
        False when no slot (or KV page budget) is available."""
        self._validate(req)
        return self._try_admit(req, self.clock.now)

    def enqueue(self, req: Request) -> bool:
        """Admission-controlled intake: queue the request, or reject it
        (backpressure) when the bounded queue is full."""
        self._validate(req)
        if len(self.queue) >= self.max_queue:
            req.status = REJECTED
            req.finish_t = self.clock.now
            self.rejected += 1
            return False
        self.queue.append(dict(req=req, eligible_at=self.clock.now))
        return True

    def _requeue(self, req: Request, *, delay: float = 0.0,
                 front: bool = False) -> None:
        entry = dict(req=req, eligible_at=self.clock.now + delay)
        if front:
            self.queue.appendleft(entry)
        else:
            self.queue.append(entry)

    def _free_slot(self, now: float) -> int | None:
        for s in range(self.slots):
            if self.active[s] is None and now >= self.failing_until[s]:
                return s
        return None

    def _try_admit(self, req: Request, now: float) -> bool:
        s = self._free_slot(now)
        if s is None:
            return False
        if self.pool is not None and req.rid not in self._page_table:
            if len(self._free_pages) < self._pages_per_seq:
                return False                      # page-budget backpressure
            self._page_table[req.rid] = [
                self._free_pages.popleft()
                for _ in range(self._pages_per_seq)]
        self._reset_slot(s)
        sus = self._suspended.pop(req.rid, None)
        if sus is not None:                       # bit-identical resume
            for k, v in sus["host"].items():
                self.cache[k][:, s] = v.to(self.device)     # in place
            if self.pool is not None:
                table = self._page_table[req.rid]
                for p in range(sus["pages"]):
                    self._unpack_page(s, p, self.pool.read(table[p]))
            self.pos[s] = sus["pos"]
        else:
            self.pos[s] = 0
        if self.pool is not None:
            self.pool.pin(self._page_table[req.rid][0])   # attention sink
        self.active[s] = req
        req.status = RUNNING
        if req.admit_t is None:
            req.admit_t = now
        req._deadline_at = (now + req.deadline
                            if req.deadline is not None else None)
        return True

    def _admit_from_queue(self, now: float) -> None:
        """Bind eligible queued requests to free slots, FIFO with head-of-
        line blocking (a head that cannot get a slot or pages holds the
        queue — that is the backpressure)."""
        while self.queue:
            head = None
            for entry in self.queue:              # first eligible entry
                if entry["eligible_at"] <= now:
                    head = entry
                    break
            if head is None or not self._try_admit(head["req"], now):
                return
            self.queue.remove(head)

    # -------------------------------------------------------- fault API --
    def fail_slot(self, s: int, *, until: float) -> None:
        """Freeze slot ``s`` until virtual time ``until`` (chaos hook):
        it makes no progress and its heartbeat inflates so the straggler
        policy can find it."""
        self.failing_until[s] = max(self.failing_until[s], until)

    def shrink_pool(self, new_hot_pages: int) -> int:
        """Live memory-pressure event: shrink the hot pool (dispersed mode;
        resident engines have nothing to shrink).  Returns pages spilled."""
        if self.pool is None:
            return 0
        floor = len(self.pool._pin_set) + 2
        return self.pool.shrink(max(int(new_hot_pages), floor))

    def preempt(self, s: int, reason: str = "") -> Request | None:
        """Spill slot ``s``'s sequence to cold and re-queue it (front).
        In dispersed mode the paged KV goes through the pool's cold
        region; host-side copies carry whatever is not paged.  The
        resumed request continues bit-identically."""
        req = self.active[s]
        if req is None:
            return None
        host_keys = self.cache if self.pool is None else self._unpaged
        snap = {k: self.cache[k][:, s].to("cpu", copy=True)
                for k in host_keys}
        pages = self._used_pages(s) if self.pool is not None else 0
        if self.pool is not None:
            table = self._page_table[req.rid]
            self.pool.unpin(table[0])
            for p in range(pages):
                self.pool.evict(table[p])         # writeback -> cold
        self._suspended[req.rid] = dict(
            pos=int(self.pos[s]), host=snap, pages=pages, reason=reason)
        req.status = PREEMPTED
        req.preemptions += 1
        self.preemptions += 1
        self.active[s] = None
        self._requeue(req, front=True)
        return req

    def _release_pages(self, req: Request) -> None:
        table = self._page_table.pop(req.rid, None)
        if table:
            for p in table:
                self.pool.release(p)
            self._free_pages.extend(table)

    def _release_request(self, req: Request) -> None:
        self._suspended.pop(req.rid, None)
        self._retry.pop(req.rid, None)
        if self.pool is not None:
            self._release_pages(req)

    def _finish(self, s: int, status: str, now: float) -> None:
        req = self.active[s]
        req.status = status
        req.done = status == DONE
        req.finish_t = now
        self.active[s] = None
        self._release_request(req)

    def _timeout(self, s: int, now: float) -> None:
        """Deadline miss: tear the attempt down and retry under bounded
        exponential backoff, or fail it when the budget is spent."""
        req = self.active[s]
        self.deadline_misses += 1
        self.timeouts += 1
        self.active[s] = None
        self._suspended.pop(req.rid, None)
        if self.pool is not None:                 # fresh attempt: pages
            self._release_pages(req)              # released
        req.out.clear()
        req.token_times.clear()
        req.first_token_t = None
        rp = self._retry.setdefault(req.rid, RestartPolicy(
            max_restarts=self.max_retries, backoff_base=self.backoff_base,
            backoff_cap=self.backoff_cap))
        delay = rp.next_delay()
        if delay is None:
            req.status = FAILED
            req.finish_t = now
            self._release_request(req)
            return
        req.status = QUEUED
        req.retries += 1
        self._requeue(req, delay=delay)

    def _check_deadlines(self, now: float) -> None:
        for s in range(self.slots):
            req = self.active[s]
            if (req is not None and req._deadline_at is not None
                    and now > req._deadline_at):
                self._timeout(s, now)

    def _observe_stragglers(self) -> None:
        if not self._recs:
            return
        verdicts = self.straggler.observe(self._recs)
        for s, verdict in verdicts.items():
            if verdict == "evict" and self.active[s] is not None:
                self.preempt(s, reason="straggler-evict")

    # ------------------------------------------------------------- steps --
    def _batch(self, tokens_np, positions_np):
        return {"tokens": torch.from_numpy(tokens_np).to(self.device),
                "positions": torch.from_numpy(positions_np).to(self.device)}

    def _sample(self, logits_row: np.ndarray) -> int:
        if self.temperature > 0:
            probs = torch.softmax(
                torch.from_numpy(logits_row) / self.temperature, dim=-1)
            return int(torch.multinomial(probs, 1, generator=self.gen))
        return int(np.argmax(logits_row))

    def step(self) -> list[tuple[Request, int]]:
        """One engine step: feed each active slot its next token (prompt
        token during prefill-by-decode, else the last sampled token),
        advance the virtual clock by the step's duration (chaos latency
        multiplier + KV pool traffic), and run detection/bookkeeping."""
        now0 = self.clock.now
        self._step_no += 1
        mult = (self.chaos.latency_multiplier(now0)
                if self.chaos is not None else 1.0)
        frozen = {s for s in range(self.slots)
                  if now0 < self.failing_until[s]
                  and self.active[s] is not None}
        occupied = [s for s in range(self.slots)
                    if self.active[s] is not None]
        # A frozen slot makes no progress: its cache slice is rolled back
        # after the decode so injected faults cannot corrupt state.
        rollback = {s: {k: v[:, s].clone() for k, v in self.cache.items()}
                    for s in frozen}

        tokens = np.zeros((self.slots, 1), np.int64)
        for s, req in enumerate(self.active):
            if req is None:
                continue
            p = int(self.pos[s])
            if p < len(req.prompt):
                tokens[s, 0] = req.prompt[p]
            elif req.out:
                tokens[s, 0] = req.out[-1]
        positions = self.pos[:, None].astype(np.int64)
        logits, self.cache = self._decode(
            self.cache, self._batch(tokens, positions))
        logits = logits[:, 0].float().cpu().numpy()
        for s, slices in rollback.items():
            for k, v in slices.items():
                self.cache[k][:, s] = v                     # in place

        emitted = []
        finished = []
        for s, req in enumerate(self.active):
            if req is None or s in frozen:
                continue
            self.pos[s] += 1
            if self.pos[s] < len(req.prompt):
                continue                       # still consuming the prompt
            tok = self._sample(logits[s])
            req.out.append(tok)
            emitted.append((req, tok))
            if (len(req.out) >= req.max_new_tokens
                    or self.pos[s] >= self.max_len - 1):
                finished.append(s)

        if self.pool is not None:
            for s, req in enumerate(self.active):
                if req is not None and s not in frozen and s not in finished:
                    self._account_dispersed(s, req)
            ops = self.pool.fills + self.pool.spills
            pool_ticks = (ops - self._pool_ops_seen) * self.fill_ticks
            self._pool_ops_seen = ops
        else:
            pool_ticks = 0.0

        dur = self.base_step_ticks * mult + pool_ticks
        now = self.clock.advance(dur)
        for req, _tok in emitted:
            if req.first_token_t is None:
                req.first_token_t = now
            req.token_times.append(now)
        for s in finished:
            self._finish(s, DONE, now)

        for s in occupied:
            slot_dur = dur * (self.STALL_FACTOR if s in frozen else 1.0)
            rec = self._heartbeats[s].beat(self._step_no, now=now,
                                           step_time=slot_dur)
            self._recs.append(rec)
        if len(self._recs) > 1000:
            del self._recs[:500]

        self.step_log.append(dict(
            t=now, dur=dur, emitted=len(emitted),
            active=len(occupied), frozen=len(frozen),
            degraded=bool(mult > 1.0 or frozen
                          or (self.pool is not None
                              and self.pool.shrinks > 0))))
        return emitted

    # --------------------------------------------------------- front door --
    def run(self, requests: list[Request], max_steps: int = 10_000):
        """Direct submission loop: no queue, deadlines or chaos."""
        queue = list(requests)
        while queue and self.submit(queue[0]):
            queue.pop(0)
        steps = 0
        while any(r is not None for r in self.active) and steps < max_steps:
            self.step()
            steps += 1
            while queue and self.submit(queue[0]):
                queue.pop(0)
        return requests

    def serve(self, scenario, *, chaos=None,
              max_steps: int = 50_000) -> list[Request]:
        """Drive a full scenario on the virtual clock: arrivals enter the
        bounded admission queue as the clock passes their arrival time,
        chaos events fire on schedule, and the loop runs until every
        request reaches a terminal state (DONE / FAILED / REJECTED).

        ``chaos`` is a :class:`FaultProfile` or a prepared
        :class:`FaultInjector`; ``scenario`` is a :class:`Scenario` or a
        plain request list (arrival times read from ``Request.arrival_t``).
        """
        if isinstance(scenario, Scenario):
            requests = scenario.requests()
        else:
            requests = list(scenario)
        if isinstance(chaos, FaultProfile):
            chaos = FaultInjector(chaos)
        self.chaos = chaos
        pending = collections.deque(
            sorted(requests, key=lambda r: (r.arrival_t, r.rid)))
        steps = 0
        while steps < max_steps:
            now = self.clock.now
            while pending and pending[0].arrival_t <= now:
                self.enqueue(pending.popleft())
            if self.chaos is not None:
                self.chaos.apply(self, now)
            self._admit_from_queue(now)
            if not any(r is not None for r in self.active):
                nxt = self._next_event_time(pending)
                if nxt is None:
                    break                          # everything terminal
                self.clock.advance_to(nxt + 1e-9)
                continue
            self.step()
            steps += 1
            now = self.clock.now
            self._check_deadlines(now)
            self._observe_stragglers()
        return requests

    def _next_event_time(self, pending) -> float | None:
        """Earliest future event while idle: next arrival, next queued
        request turning eligible, or a quarantined slot healing."""
        times = []
        if pending:
            times.append(pending[0].arrival_t)
        if self.queue:
            times.append(min(e["eligible_at"] for e in self.queue))
            # queue blocked on quarantined slots: wait for one to heal
            if all(self.active[s] is not None
                   or self.clock.now < self.failing_until[s]
                   for s in range(self.slots)):
                times.append(float(self.failing_until.min()))
        return min(times) if times else None
