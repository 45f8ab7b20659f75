"""Spans and counters at the port's layer boundaries, recorded only while
a torch profiler records.

``span(name)`` is a context manager.  With no profiler recording
(``torch.autograd._profiler_enabled()`` false) it is one shared no-op
and nothing is kept.  While one records, each span

1. opens the profiler's record function of the same name
   (``torch._C._profiler._RecordFunctionFast``), so that it sits in the
   profiler's own timeline as a host event.  Not
   ``torch.profiler.record_function``: the profiler gives that a shadow
   on the device's timeline, which a reader of the trace that cannot
   see the event's kind (torch 2.11) counts as a device operation;
2. appends to an in-memory record its name, its parent's index, the
   step number of its root span, and its start and end from
   ``time.time_ns()`` (the clock the profiler's events carry);
3. if ``device`` names a CUDA device, records a timing
   ``torch.cuda.Event`` on that device's current stream at entry and at
   exit.

Spans never synchronise: the events' times are read by ``recorded()``,
once the work they mark is done.  ``count(name, n)`` adds to a counter
on the innermost open span.  Spans of one thread nest; the port opens
them on the main thread only.

Names are ``repro_torch.<layer>.<phase>``.
"""

from __future__ import annotations

import contextlib
import time

import torch

_NOOP = contextlib.nullcontext()
_spans: list[dict] = []           # the record, in order of entry
_open: list[dict] = []            # the open spans' entries, innermost last

# A process's first record function takes one to several milliseconds
# between its event's start and its return (the profiler ops' first
# dispatch).  Pay that here, with no profiler recording, so that no span
# of a traced window, the port's or its caller's, carries it.
with torch.profiler.record_function("repro_torch.tracing.warm"), \
        torch._C._profiler._RecordFunctionFast("repro_torch.tracing.warm"):
    pass


def span(name: str, *, step: int | None = None, device=None):
    """A span named ``name``; ``step`` numbers a root span (its children
    take their root's); with ``device`` on a CUDA device the span is
    also timed on the device's clock."""
    if not torch.autograd._profiler_enabled():
        return _NOOP
    return _span(name, step, device)


@contextlib.contextmanager
def _span(name, step, device):
    stream = None
    if device is not None and torch.device(device).type == "cuda":
        stream = torch.cuda.current_stream(device)
    parent = _open[-1] if _open else None
    rec = {"name": name,
           "parent": None if parent is None else parent["index"],
           "step": step if parent is None else parent["step"],
           "index": len(_spans), "start_ns": 0, "end_ns": None,
           "device_ms": None, "counters": {}}
    with torch._C._profiler._RecordFunctionFast(name):
        rec["start_ns"] = time.time_ns()
        if stream is not None:
            begin = torch.cuda.Event(enable_timing=True)
            begin.record(stream)
        _spans.append(rec)
        _open.append(rec)
        try:
            yield rec
        finally:
            if _open and _open[-1] is rec:
                _open.pop()
            if stream is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record(stream)
                rec["_events"] = (begin, end)
            rec["end_ns"] = time.time_ns()


def count(name: str, n) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span (nothing
    when no span is open)."""
    if _open:
        counters = _open[-1]["counters"]
        counters[name] = counters.get(name, 0) + n


def device_allocs(device) -> int | None:
    """The caching allocator's ``cudaMalloc`` count so far on ``device``
    while the tracer is on and ``device`` is a CUDA device, else None."""
    if not torch.autograd._profiler_enabled() or \
            torch.device(device).type != "cuda":
        return None
    return torch.cuda.memory_stats(device)["num_device_alloc"]


def recorded() -> list[dict]:
    """The record: one dict a span (``name``, ``parent``: the parent's
    ``index`` in the record, ``step``, ``index``, ``start_ns``,
    ``end_ns``, ``device_ms`` where timed, ``counters``).  Reading a
    timed span waits for its end event."""
    out = []
    for rec in _spans:
        events = rec.pop("_events", None)
        if events is not None:
            begin, end = events
            end.synchronize()
            rec["device_ms"] = begin.elapsed_time(end)
        out.append(dict(rec, counters=dict(rec["counters"])))
    return out


def clear() -> None:
    """Empty the record (spans still open keep running, unrecorded)."""
    _spans.clear()
    _open.clear()
