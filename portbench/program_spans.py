"""Readings of the port's own spans and counters in a traced training
window (``repro_torch.runtime.tracing``, which records while the
benchmark's profiler does).

The port opens ``repro_torch.train.step`` around each step (counter
``alloc.device_allocs``) and, inside it, ``repro_torch.train.forward``
and ``repro_torch.train.backward`` once a microbatch and
``repro_torch.optim.update`` once; those three carry their device window
(ms between two CUDA events).  The window's steps are the last
``ctx["steps"]`` root step spans of the record.

Its host times (``time.time_ns()``) go onto the trace's window-relative
clock by one offset: each ``portbench.train.step`` span of the trace
encloses one port step span, opened microseconds later, and the offset
is the median of those differences.  A step further than
``MAX_SKEW_S`` from it means the clocks do not line up, and the idle
readings are then None.

A tree whose program has no tracer gives no record, and every reading
is None.
"""

from __future__ import annotations

import bisect
import statistics
import sys

STEP = "repro_torch.train.step"
PHASES = {"forward": "repro_torch.train.forward",
          "backward": "repro_torch.train.backward",
          "optimizer": "repro_torch.optim.update"}
BENCH_STEP = "portbench.train.step"
ALLOCS = "alloc.device_allocs"
MAX_SKEW_S = 200e-6


def record():
    """The port's record, or None where the program has no tracer."""
    try:
        from repro_torch.runtime import tracing
    except ImportError:
        return None
    return tracing.recorded()


def window(ctx, rec=None):
    """(the window's root step spans, each phase's spans opened directly
    inside them), or None."""
    rec = record() if rec is None else rec
    steps = ctx["steps"]
    if not rec or not steps:
        return None
    roots = [s for s in rec if s["name"] == STEP and s["parent"] is None]
    if len(roots) < steps:
        return None
    roots = roots[-steps:]
    ids = {r["index"] for r in roots}
    phases = {p: [s for s in rec if s["name"] == name and s["parent"] in ids]
              for p, name in PHASES.items()}
    return roots, phases


def window_ms(ctx, phase: str, rec=None):
    """The phase's device window a step, in ms: its spans' device ms
    summed over the window, over the steps; None without events."""
    got = window(ctx, rec)
    if got is None:
        return None
    spans = got[1][phase]
    if not spans or any(s["device_ms"] is None for s in spans):
        return None
    return sum(s["device_ms"] for s in spans) / ctx["steps"]


def device_allocs(ctx, rec=None):
    """The allocator's device allocations a step over the window (the
    step spans' ``alloc.device_allocs``), or None where not counted."""
    got = window(ctx, rec)
    if got is None:
        return None
    counts = [r["counters"].get(ALLOCS) for r in got[0]]
    if any(c is None for c in counts):
        return None
    return sum(counts) / ctx["steps"]


def offset(ctx, rec=None):
    """(offset in ns from the trace's clock to the port's, the largest
    step's deviation from it in s), or None where the steps do not
    pair."""
    got = window(ctx, rec)
    trace = ctx["trace"]
    if got is None or trace is None:
        return None
    bench = sorted(s for name, s, _ in trace.spans if name == BENCH_STEP)
    roots = got[0]
    if len(bench) != len(roots):
        return None
    diffs = [r["start_ns"] - round(b * 1e9) for r, b in zip(roots, bench)]
    med = round(statistics.median(diffs))
    return med, max(abs(d - med) for d in diffs) / 1e9


def gaps(trace):
    """The window's device idle gaps as (start_s, end_s): the complement
    of the union of its operations in [0, window_s], as
    ``Trace.busy_s`` counts it."""
    out, last = [], 0.0
    for _, s, e in trace.ops:
        s, e = max(s, 0.0), min(e, trace.window_s)
        if e <= s:
            continue
        if s > last:
            out.append((last, s))
        last = max(last, e)
    if trace.window_s > last:
        out.append((last, trace.window_s))
    return out


def idle_ms(ctx, rec=None):
    """The window's device idle a step, in ms, by the phase the host was
    in when each gap ended (``forward``, ``backward``, ``optimizer``),
    and ``rest``: gaps that ended outside every phase span.  None where
    the clocks do not line up.  Kept in ``ctx`` once read."""
    if "program_idle_ms" in ctx and rec is None:
        return ctx["program_idle_ms"]
    got, off = window(ctx, rec), offset(ctx, rec)
    out = None
    if got is not None and off is not None:
        off_ns, skew = off
        print(f"program_spans: {len(got[0])} steps, clock offset "
              f"{off_ns} ns, largest step deviation {skew * 1e6:.1f} us",
              file=sys.stderr)
        if skew <= MAX_SKEW_S:
            out = _attribute(ctx, got[1], off_ns)
    if rec is None:
        ctx["program_idle_ms"] = out
    return out


def _attribute(ctx, phases: dict, off_ns: int) -> dict:
    spans = sorted(((s["start_ns"] - off_ns) / 1e9,
                    (s["end_ns"] - off_ns) / 1e9, p)
                   for p, ss in phases.items() for s in ss)
    starts = [s for s, _, _ in spans]
    idle = {p: 0.0 for p in PHASES}
    rest = 0.0
    for g0, g1 in gaps(ctx["trace"]):
        i = bisect.bisect_right(starts, g1) - 1
        if i >= 0 and g1 < spans[i][1]:
            idle[spans[i][2]] += g1 - g0
        else:
            rest += g1 - g0
    idle["rest"] = rest
    return {p: v / ctx["steps"] * 1e3 for p, v in idle.items()}
