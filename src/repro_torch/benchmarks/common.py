"""Shared benchmark utilities — a thin shim over the process-default
:class:`repro_torch.api.Session` (the port of ``benchmarks/common.py``).

The Session owns the caches: built kernels and prepared traces, keyed by
(name, params, fold, max_events, fold warm-up — a function of the static
L1 geometry only).  Suites that sweep through this module share the
default Session's caches; new code should construct a
:class:`repro_torch.api.Sweep` and call ``Session.run`` directly.
"""

from __future__ import annotations

import time
import warnings

from repro_torch import api
from repro_torch.core import simulator


def built(name):
    """Build (and cache) a paper-size benchmark trace."""
    return api.default_session().built(name)


def prepared_for(name, fold=True, max_events=None,
                 machine=simulator.DEFAULT_MACHINE) -> simulator.PreparedTrace:
    """Prepared (expanded + folded) trace per benchmark, session-cached.

    ``max_events`` truncation is deprecated here: declare the budget on a
    :class:`repro_torch.api.Sweep` (``Sweep(max_events=...)``) instead.
    """
    if max_events is not None:
        warnings.warn(
            "prepared_for(max_events=...) is deprecated; pass max_events to "
            "a repro_torch.api.Sweep (or Session.prepared) instead",
            DeprecationWarning, stacklevel=2)
    return api.default_session().prepared(name, fold=fold,
                                          max_events=max_events,
                                          machine=machine)


def sweep_grid(names, sweep, fold=True, max_events=None, refine=True,
               machine=simulator.DEFAULT_MACHINE):
    """One sweep call for a whole suite: P programs x C configs — and, when
    ``machine`` is a :class:`simulator.MachineSweep`, x M machine points in
    the same engine call.  Delegates to ``Session.grid`` on the
    process-default session (which owns the caches and the fold/refine
    policy)."""
    return api.default_session().grid(names, sweep, machine=machine,
                                      fold=fold, max_events=max_events,
                                      refine=refine)


def emit(rows: list[dict], header: list[str]) -> None:
    """Print ``rows`` as CSV under ``header`` (missing fields empty)."""
    print(",".join(header))
    for r in rows:
        print(",".join(str(r.get(h, "")) for h in header))


def timed(fn, *args, **kw):
    t0 = time.time()
    out = fn(*args, **kw)
    return out, time.time() - t0
