"""Exact periodic folding of repeat-generated instruction traces.

``Assembler.repeat`` records ``(start, block_len, count)`` metadata for every
expanded repeat block (``Program.repeats``).  Hot benchmark loops are
periodic, so instead of simulating millions of near-identical iterations (or
lossily truncating the trace, as the old ``MAX_EVENTS`` prefix did), we

  1. keep a *warm-up* prefix of each sufficiently long repeat block — enough
     iterations to stream ~2x the L1 capacity so the cache reaches its
     steady state,
  2. keep two further *measured* super-periods A and B, and
  3. drop the remaining iterations, giving every instruction of B an integer
     extrapolation ``weight`` so counters come out as
     ``total = head + warmup + A + (count - warmup - 1) * B``.

Folding is recursive (blocks nested inside a kept period fold again) and
multiplicative (a nested B weight multiplies the enclosing one).  The
simulator accumulates three counter sets — total (weighted), period A and
period B — and reports ``fold_exact`` when A == B, i.e. the trace really was
in steady state and the algebraic extrapolation is exact.

Machine axes: the fold plan depends only on the *address stream* and the
static L1 geometry (warm-up streams 2x its line count, see
:func:`warm_lines_for`) — never on the traced latency parameters, which
affect cycle arithmetic but no replacement decision.  The A == B
certificate is therefore evaluated independently at every (capacity,
policy, machine) grid point, so one fold plan extrapolates exactly across
a whole traced machine sweep.

A *super-period* groups ``unit`` consecutive iterations (8 by default when
the count allows) so that sub-cacheline strides (e.g. 4-byte broadcast
streams, 8 elements per 32-byte line) complete a whole line per measured
period and the per-period counter deltas are constant.

State-snapshot period detection (multi-iteration steady states)
---------------------------------------------------------------

Some kernels reach steady state only over a period *longer than one
iteration of any single emitted repeat*: jacobi2d's ping-pong buffers swap
source and destination every time step, so the trace is periodic with
period TWO steps, a loop the Assembler never emitted as one repeat block.
:func:`plan` therefore runs a detection pass over runs of adjacent
top-level repeat blocks: it finds the smallest k for which the instruction
stream is literally periodic with a k-block super-period, then certifies
the candidate by *state snapshots* — fingerprints of the address stream's
cache-relevant state (per-line last-touch offsets + the stale-line set) at
every candidate period boundary.  The first boundary from which all
fingerprints agree sizes the warm-up; a candidate whose fingerprints never
stabilise is rejected.  Accepted candidates are synthesised as ordinary
fold segments (``ping-pong => k = 2`` blocks per period) and folded by the
standard warm-up + A + B machinery.

Exact-outer planning (certifying folds the nested plan cannot)
--------------------------------------------------------------

The nested plan folds every sufficiently long loop, including loops inside
another fold's warm-up and measured periods.  That maximises compression
but leaves the simulated cache state *approximate* inside each kept outer
period, and drops iterations whose lines later rows reuse — both of which
forfeit the exactness certificate (``FoldPlan.certifiable``).  When that
happens, :func:`plan` re-plans in *exact-outer* mode: only the outermost
foldable block of each nest folds, and its warm-up and measured periods
are simulated in full (no nested folding), so A and B measure the true
per-period counters.  The certified exact-outer plan keeps more rows than
the nested one but replaces a full unfolded re-simulation; the nested plan
is kept whenever exact-outer cannot be certified either.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.trace import Program

#: Fields that must match for two trace rows to be considered identical by
#: the super-period detector (everything the simulator reads).
_PERIODIC_FIELDS = ("op", "vd", "vs1", "vs2", "addr", "imm", "cost_override")


def warm_lines_for(l1_sets: int, l1_ways: int) -> int:
    """Warm-up stream length (cachelines) for an L1 geometry: 2x its line
    count reaches LRU steady state within every set before measurement."""
    return 2 * l1_sets * l1_ways


@dataclasses.dataclass
class FoldPlan:
    """Row selection + extrapolation weights for a folded trace."""

    rows: np.ndarray      # (T',) int64 kept instruction rows, ascending
    weight: np.ndarray    # (T',) int32 total-counter weight per row
    wa: np.ndarray        # (T',) int32 contribution to one measured period A
    wb: np.ndarray        # (T',) int32 contribution to one measured period B
    num_folds: int        # repeat blocks actually folded
    num_rows_full: int    # rows of the unfolded trace
    certifiable: bool = True   # False: kept rows after a folded block reuse
    #   the block's dropped lines, so the runtime A == B check cannot see
    #   the post-loop state divergence and must not certify exactness.
    num_super_periods: int = 0   # detected multi-block super-periods folded
    exact_outer: bool = False    # plan came from the exact-outer re-plan

    @property
    def kept_fraction(self) -> float:
        return len(self.rows) / max(self.num_rows_full, 1)


@dataclasses.dataclass
class _Node:
    s: int
    bl: int
    cnt: int
    children: list
    super_: bool = False     # synthesised multi-block super-period
    warm: int = 0            # snapshot-derived warm-up (super nodes only)

    @property
    def e(self) -> int:
        return self.s + self.bl * self.cnt


def _build_tree(nodes: list) -> list:
    """Nest _Node segments by containment (they are properly nested or
    disjoint by construction).  Children are rebuilt from scratch so the
    same nodes can be re-treed across planning passes."""
    nodes = sorted(nodes, key=lambda n: (n.s, -(n.bl * n.cnt)))
    roots, stack = [], []
    for nd in nodes:
        nd.children = []
    for nd in nodes:
        while stack and nd.s >= stack[-1].e:
            stack.pop()
        (stack[-1].children if stack else roots).append(nd)
        stack.append(nd)
    return roots


# ---------------------------------------------------------------------------
# State-snapshot super-period detection.
# ---------------------------------------------------------------------------


def _rows_periodic(program: Program, s: int, P: int, cnt: int) -> bool:
    """True when rows [s, s + cnt*P) are literally periodic with period P
    on every simulator-visible field."""
    if cnt < 2:
        return False
    for f in _PERIODIC_FIELDS:
        arr = getattr(program, f)
        if not np.array_equal(arr[s: s + (cnt - 1) * P],
                              arr[s + P: s + cnt * P]):
            return False
    return True


def _boundary_fingerprint(addr: np.ndarray, s: int, P: int, j: int,
                          seen_before: set):
    """Cache-state fingerprint at the end of period ``j`` of a candidate
    super-period: (line -> last-touch offset within the period) plus the
    set of *stale* lines (touched earlier, untouched this period).  Two
    boundaries with equal fingerprints present the same relative-recency
    state to an LRU-like cache — absolute ages differ, but every
    replacement decision the engine makes compares ages, not reads them.
    """
    a = addr[s + j * P: s + (j + 1) * P]
    idx = np.flatnonzero(a >= 0)
    lines = (a[idx] >> 5).astype(np.int64)
    # last occurrence per line: unique() on the reversed stream returns the
    # first (= originally last) index of each line.
    rev_lines = lines[::-1]
    u, first_rev = np.unique(rev_lines, return_index=True)
    last_off = idx[len(idx) - 1 - first_rev]
    touched = set(u.tolist())
    stale = frozenset(seen_before - touched)
    return (tuple(u.tolist()), tuple(last_off.tolist()), stale), touched


def _snapshot_warm(addr: np.ndarray, s: int, P: int, cnt: int) -> int | None:
    """Snapshot the address stream's state at every candidate period
    boundary and return the first warm-up count w >= 1 from which all
    remaining fingerprints agree (steady state reached), or None when the
    fingerprints never stabilise."""
    pre = addr[:s]
    seen = set(np.unique(pre[pre >= 0] >> 5).tolist())
    fps = []
    for j in range(cnt):
        fp, touched = _boundary_fingerprint(addr, s, P, j, seen)
        seen |= touched
        fps.append(fp)
    for w in range(1, cnt - 2):          # leave >= A + B after the warm-up
        if all(fp == fps[w] for fp in fps[w + 1:]):
            return w
    return None


def detect_super_periods(program: Program):
    """Detect multi-block steady-state periods over runs of adjacent
    top-level repeat blocks.

    Returns synthesised ``_Node`` segments (``super_=True``) whose period
    spans k >= 1 consecutive top-level blocks, with the snapshot-derived
    warm-up attached.  A ping-pong time loop (jacobi2d) detects k = 2; a
    plain unrolled loop of identical blocks detects k = 1.
    """
    base = [_Node(s, bl, cnt, []) for s, bl, cnt in program.repeats]
    if not base:
        return []
    roots = _build_tree(base)
    runs, cur = [], [roots[0]]
    for nd in roots[1:]:
        if nd.s == cur[-1].e:
            cur.append(nd)
        else:
            runs.append(cur)
            cur = [nd]
    runs.append(cur)
    out = []
    for run in runs:
        m = len(run)
        if m < 4:
            continue
        S = run[0].s
        for k in range(1, m // 4 + 1):
            cnt = m // k
            P = run[k].s - S
            if any(run[j * k].s != S + j * P for j in range(cnt)):
                continue            # unequal block lengths inside the period
            if S + cnt * P > run[-1].e:
                continue
            if not _rows_periodic(program, S, P, cnt):
                continue
            warm = _snapshot_warm(program.addr, S, P, cnt)
            if warm is None:
                continue
            out.append(_Node(S, P, cnt, [], super_=True, warm=warm))
            break                   # smallest k wins
    return out


# ---------------------------------------------------------------------------
# Stream analysis helpers (module level so :func:`diagnose` can report the
# same judgements the planner makes).
# ---------------------------------------------------------------------------


def _lines_in(addr: np.ndarray, lo: int, hi: int) -> int:
    a = addr[lo:hi]
    a = a[a >= 0]
    return len(np.unique(a >> 5)) if a.size else 0


def _new_lines_steady(addr: np.ndarray, s: int, P: int, reps: int) -> bool:
    """True when super-periods 1..k touch a constant number of lines
    never seen in earlier super-periods (translation-invariant pattern;
    period 0 owns the first-touch of loop-invariant data)."""
    seen: set = set()
    news = []
    for sp in range(min(8, reps)):
        a = addr[s + sp * P: s + (sp + 1) * P]
        cur = set((a[a >= 0] >> 5).tolist())
        news.append(len(cur - seen))
        seen |= cur
    return len(set(news[1:])) <= 1


def reuse_gaps_stationary(addr: np.ndarray, s: int, e: int, P: int,
                          start: int = 2) -> bool:
    """True when the multiset of cross-period line-reuse gaps landing in
    each super-period is the same for every period (first ``start``
    periods own first-touch transients and are exempt).

    This is the translation-invariance the A == B certificate silently
    assumes.  Two streams walking one region at different line rates
    (e.g. a stride-64 load overtaken by a stride-32 store) re-touch
    line ``2k`` at periods ``k`` and ``2k - 1``: every per-line gap is
    unique, but the gap *arriving* at period ``p`` grows with ``p``, so
    the reuse distance crosses the L1 reach somewhere inside the
    extrapolated region — the two measured periods still agree while
    the steady state they certify is not the block's.  Such folds stay
    honest: folded for speed, never certified exact."""
    a = addr[s:e]
    idx = np.flatnonzero(a >= 0)
    if idx.size == 0:
        return True
    lines = (a[idx] >> 5).astype(np.int64)
    per = idx // P
    order = np.argsort(lines, kind="stable")   # trace order within line
    l_s, p_s = lines[order], per[order]
    cross = (l_s[1:] == l_s[:-1]) & (p_s[1:] > p_s[:-1])
    p2 = p_s[1:][cross]                        # period the reuse lands in
    gap = (p_s[1:] - p_s[:-1])[cross]
    keep = p2 >= start
    p2, gap = p2[keep], gap[keep]
    nper = (e - s) // P
    if nper <= start:
        return True
    if p2.size == 0:
        return True
    counts = np.bincount(p2, minlength=nper)[start:]
    if (counts != counts[0]).any():
        return False
    if counts[0] == 0:
        return True
    o = np.lexsort((gap, p2))
    sig = gap[o].reshape(nper - start, counts[0])
    return bool((sig == sig[0]).all())


def _choose_unit(addr: np.ndarray, nd: "_Node", warm_lines: int,
                 units: tuple):
    """Pick the measurement unit for a repeat block, exactly as the planner
    does: the unit whose warm-up + 2 measured super-periods keeps the fewest
    rows, with steady new-line units strongly preferred.  Returns
    ``(unit, reps, warm, key)`` or None when no unit leaves >= 1
    extrapolated period."""
    if nd.super_:
        u, reps, warm = 1, nd.cnt, max(1, nd.warm)
        kept = (warm + 2) * nd.bl
        return ((u, reps, warm, (False, kept))
                if reps >= warm + 3 else None)
    chosen = None
    for u in units:
        if nd.cnt % u:
            continue
        reps = nd.cnt // u
        per_sp = _lines_in(addr, nd.s, nd.s + u * nd.bl)
        warm = max(1, -(-warm_lines // per_sp)) if per_sp else 1
        if reps >= warm + 3:                # >=1 extrapolated period
            steady_u = _new_lines_steady(addr, nd.s, u * nd.bl, reps)
            kept = (warm + 2) * u * nd.bl
            key = (not steady_u, kept)      # steady units first
            if chosen is None or key < chosen[3]:
                chosen = (u, reps, warm, key)
    return chosen


# ---------------------------------------------------------------------------
# Plan construction.
# ---------------------------------------------------------------------------


def _plan_once(program: Program, nodes: list, warm_lines: int, units: tuple,
               exact_outer: bool) -> FoldPlan | None:
    """One planning pass.  ``exact_outer``: the outermost folded block of
    each nest simulates its kept periods in full (children never fold), so
    the measured A and B are the true per-period counters."""
    T = program.num_instructions
    addr = program.addr
    roots = _build_tree(nodes)

    ranges: list[tuple[int, int, int, int, int]] = []   # (lo, hi, w, wa, wb)
    state = {"folds": 0, "supers": 0}
    dropped: list[tuple[int, int]] = []     # extrapolated (unkept) regions

    def emit_range(lo, hi, children, w, wa, wb, in_fold):
        cur = lo
        for ch in children:
            if ch.s > cur:
                ranges.append((cur, ch.s, w, wa, wb))
            emit_node(ch, w, wa, wb, in_fold)
            cur = ch.e
        if cur < hi:
            ranges.append((cur, hi, w, wa, wb))

    def emit_node(nd, w, wa, wb, in_fold):
        # Unit choice (see _choose_unit): synthesised super-periods use the
        # detected k-block span and snapshot warm-up; plain blocks pick the
        # unit whose warm-up + 2 measured super-periods keeps the fewest
        # rows, preferring units whose early super-periods touch a constant
        # number of distinct lines.
        chosen = _choose_unit(addr, nd, warm_lines, units)
        if chosen is None or chosen[3][1] >= 0.95 * (nd.e - nd.s):
            emit_range(nd.s, nd.e, nd.children, w, wa, wb, in_fold)
            return
        u, reps, warm, _ = chosen
        state["folds"] += 1
        if nd.super_:
            state["supers"] += 1
        P = u * nd.bl
        rest = reps - warm - 2
        dropped.append((nd.s + (warm + 2) * P, nd.e))
        if not reuse_gaps_stationary(addr, nd.s, nd.e, P):
            state["non_stationary"] = True
        for sp in range(warm + 2):
            lo = nd.s + sp * P
            hi = lo + P
            if sp < warm:
                f = (w, wa, wb)
            elif sp == warm:                        # measured period A
                f = (w, wa, wb) if in_fold else (w, w, 0)
            else:                                   # measured period B
                m = 1 + rest
                f = (w * m, wa * m, wb * m) if in_fold else (w * m, 0, w)
            if exact_outer:
                ranges.append((lo, hi, *f))         # full, un-nested period
            else:
                kids = [c for c in nd.children if c.s >= lo and c.e <= hi]
                emit_range(lo, hi, kids, *f, in_fold=True)

    emit_range(0, T, roots, 1, 0, 0, False)
    if not state["folds"]:
        return None
    rows = np.concatenate([np.arange(lo, hi, dtype=np.int64)
                           for lo, hi, *_ in ranges])
    w = np.concatenate([np.full(hi - lo, wv, np.int32)
                        for lo, hi, wv, _, _ in ranges])
    wa = np.concatenate([np.full(hi - lo, av, np.int32)
                         for lo, hi, _, av, _ in ranges])
    wb = np.concatenate([np.full(hi - lo, bv, np.int32)
                         for lo, hi, _, _, bv in ranges])
    # Post-loop state divergence check: the simulated trace leaves the
    # caches in period-B-end state, the real trace in last-period state.
    # If any kept row AFTER a folded block touches a line its dropped
    # periods touched, the runtime A == B check cannot see the difference,
    # so the plan must not be certified exact.  Within-loop divergence
    # (non-stationary reuse gaps, see ``reuse_gaps_stationary``) is caught
    # the same way: fold anyway, never certify.
    certifiable = not state.get("non_stationary", False)
    for d_lo, d_hi in dropped:
        tail = rows[np.searchsorted(rows, d_hi):]
        if not tail.size:
            continue
        a_t = addr[tail]
        a_d = addr[d_lo:d_hi]
        t_lines = np.unique(a_t[a_t >= 0] >> 5)
        d_lines = np.unique(a_d[a_d >= 0] >> 5)
        if np.intersect1d(t_lines, d_lines, assume_unique=True).size:
            certifiable = False
            break
    return FoldPlan(rows=rows, weight=w, wa=wa, wb=wb,
                    num_folds=state["folds"], num_rows_full=T,
                    certifiable=certifiable,
                    num_super_periods=state["supers"],
                    exact_outer=exact_outer)


def plan(program: Program, warm_lines: int = 1024,
         units: tuple = (8, 4, 2, 1)) -> FoldPlan | None:
    """Build a fold plan for ``program`` (None when nothing folds).

    ``warm_lines``: cachelines each fold's warm-up must stream before the
    measured periods (default 2x a 16 KB / 32 B-line L1).

    Planning is two-pass: the *nested* pass folds every sufficiently long
    loop (maximum compression); when its certificate fails — nested folds
    perturb the warm-up state, or dropped iterations' lines are reused
    later — the *exact-outer* pass re-plans with only the outermost block
    of each nest folded and its kept periods simulated in full.  The
    certified plan wins; when neither certifies, the nested plan is kept
    (folded for speed, honestly flagged).
    """
    if not program.repeats:
        return None
    base = [_Node(s, bl, cnt, []) for s, bl, cnt in program.repeats]
    nodes = base + detect_super_periods(program)
    nested = _plan_once(program, nodes, warm_lines, units, exact_outer=False)
    if nested is None or nested.certifiable:
        return nested
    exact = _plan_once(program, nodes, warm_lines, units, exact_outer=True)
    if exact is not None and exact.certifiable:
        return exact
    return nested


def diagnose(program: Program, warm_lines: int = 1024,
             units: tuple = (8, 4, 2, 1)) -> list[dict]:
    """Per-block fold diagnostics: why each repeat block does or does not
    certify.

    For every top-level repeat block and every detected multi-block
    super-period, report the planner's unit choice and the two stream
    invariants the A == B certificate rests on:

    - ``stationary``: cross-period line-reuse gaps are translation
      invariant (:func:`reuse_gaps_stationary`) — False is exactly the
      multi-rate-stream condition that keeps a fold honest but uncertified
      (somier's within-step force/integrate streams are the canonical
      case).
    - ``steady_new_lines``: successive super-periods touch a constant
      number of never-seen lines (:func:`_new_lines_steady`).

    ``foldable`` is False when no unit leaves at least one extrapolated
    period after the warm-up (the block is too short for its warm-up, e.g.
    somier at the paper's 2 time steps vs the detector's 4-period minimum).
    The list is ordered by block start row.
    """
    addr = program.addr
    base = [_Node(s, bl, cnt, []) for s, bl, cnt in program.repeats]
    roots = _build_tree(base)
    out = []
    for nd in roots + detect_super_periods(program):
        chosen = _choose_unit(addr, nd, warm_lines, units)
        rec = dict(start=int(nd.s), end=int(nd.e), block_len=int(nd.bl),
                   count=int(nd.cnt), super_period=bool(nd.super_),
                   foldable=chosen is not None)
        if chosen is not None:
            u, reps, warm, _ = chosen
            P = u * nd.bl
            rec.update(
                unit=int(u), reps=int(reps), warm=int(warm),
                stationary=reuse_gaps_stationary(addr, nd.s, nd.e, P),
                steady_new_lines=_new_lines_steady(addr, nd.s, P, reps))
        out.append(rec)
    return sorted(out, key=lambda r: (r["start"], r["super_period"]))
