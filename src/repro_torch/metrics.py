"""Metrics as an API: a registry of derived quantities over labeled
:class:`repro_torch.api.SweepResult` grids.

Port of the registry core of ``repro/metrics.py`` (:class:`Metric`,
:func:`register`, :func:`unregister`, :func:`get`, :func:`names`,
:class:`MetricContext`, :func:`evaluate`) and of the three roofline
metrics ``arithmetic_intensity``, ``model_arithmetic_intensity`` and
``achieved_gflops``.  Three kinds:

  * **derived** — pointwise counter algebra;
  * **model** — cost models evaluated over the grid;
  * **relational** — quantities relative to a baseline point of the same
    sweep; they take an explicit ``baseline=`` axis selection.

The cost-model, cluster and silicon metrics, and the lazy loading of the
silicon plugin, follow when ``core/costmodel.py`` and ``silicon/`` are
ported.  Evaluation is pure numpy on counters the sweep already produced.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.api import _CONFIG_FIELDS, _GEOMETRY_FIELDS

__all__ = [
    "Metric", "MetricContext", "register", "unregister", "get", "names",
    "evaluate", "KINDS",
]

KINDS = ("derived", "model", "relational")


@dataclasses.dataclass(frozen=True)
class Metric:
    """One registered metric: a named, documented function over a labeled
    counter grid.  ``fn(ctx)`` for derived/model kinds, ``fn(ctx, base)``
    for relational ones (``base`` is the baseline-aligned view).
    ``params`` names the keyword parameters the metric accepts —
    ``evaluate`` rejects unknown ones; ``None`` skips the check (for
    free-form custom metrics)."""

    name: str
    kind: str
    doc: str
    fn: Callable
    params: tuple | None = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"metric kind must be one of {KINDS}, got {self.kind!r}")


_REGISTRY: dict[str, Metric] = {}


def register(name: str, kind: str, doc: str = "", override: bool = False,
             params: tuple | None = None):
    """Decorator registering a metric function under ``name``.

    ``kind`` is ``"derived"`` / ``"model"`` / ``"relational"``; ``doc``
    is the one-line description of the metric;
    ``params`` names the accepted keyword parameters (unknown ones are
    rejected at evaluation; ``None`` — the default for custom metrics —
    accepts anything).  Re-registering an existing name raises unless
    ``override=True``.
    """
    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY and not override:
            raise ValueError(f"metric {name!r} registered twice "
                             "(pass override=True to replace)")
        _REGISTRY[name] = Metric(name, kind, doc or (fn.__doc__ or ""), fn,
                                 tuple(params) if params is not None
                                 else None)
        return fn
    return deco


def unregister(name: str) -> None:
    """Remove a registered metric (tests and notebook experimentation)."""
    _REGISTRY.pop(name, None)


def get(metric) -> Metric:
    """Registry lookup; unknown names raise with the sorted menu."""
    if isinstance(metric, Metric):
        return metric
    try:
        return _REGISTRY[metric]
    except KeyError:
        raise KeyError(
            f"unknown metric {metric!r}; registered: "
            f"{', '.join(sorted(_REGISTRY))}") from None


def names() -> list[str]:
    """Sorted names of every registered metric."""
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Evaluation context.
# ---------------------------------------------------------------------------


class MetricContext:
    """What a metric function sees: the grid's counters, the axis values
    broadcast as grids, and the call's parameters.

    ``counter(name)`` returns the named counter array — or, when ``name``
    is itself a registered derived/model metric not yet in the data,
    evaluates it on demand so metrics compose.  The call's parameters
    propagate down the composition chain; only parameter-free evaluations are
    cached into the result (a parameterised sub-metric under its
    canonical name would poison later reads).
    """

    def __init__(self, result, params: dict | None = None, _stack=()):
        self.result = result
        self.params = dict(params or {})
        self._stack = _stack

    @property
    def shape(self) -> tuple[int, ...]:
        return self.result.shape

    def counter(self, name: str) -> np.ndarray:
        data = self.result.data
        if name in data:
            return data[name]
        if name in _REGISTRY:
            if name in self._stack:
                raise ValueError(
                    f"metric dependency cycle: {' -> '.join(self._stack)}"
                    f" -> {name}")
            m = _REGISTRY[name]
            if m.kind == "relational":
                raise ValueError(
                    f"metric {name!r} is relational — derive it explicitly "
                    "with a baseline= selection first")
            sub = MetricContext(self.result, self.params,
                                self._stack + (name,))
            arr = np.broadcast_to(
                np.asarray(m.fn(sub)), self.shape).copy()
            if not self.params:
                data[name] = arr
            return arr
        raise KeyError(
            f"no counter or registered metric {name!r}; counters: "
            f"{sorted(data)}")

    def axis_values(self, name: str) -> tuple:
        return self.result.axis(name).values

    def axis_grid(self, name: str) -> np.ndarray:
        """The per-point values of one axis (or config/geometry field),
        shaped to broadcast against the counter grids."""
        axes = self.result.axes
        axis_names = [a.name for a in axes]
        if name in axis_names:
            ai = axis_names.index(name)
            vals = list(axes[ai].values)
        elif name in _CONFIG_FIELDS and "config" in axis_names:
            ai = axis_names.index("config")
            vals = [getattr(c, name) for c in axes[ai].values]
        elif name in _GEOMETRY_FIELDS and "l1_geometry" in axis_names:
            ai = axis_names.index("l1_geometry")
            vals = [getattr(g, _GEOMETRY_FIELDS[name])
                    for g in axes[ai].values]
        else:
            raise KeyError(
                f"no axis or axis field {name!r}; axes: {axis_names}")
        arr = np.asarray(vals)
        shape = [1] * len(axes)
        shape[ai] = len(vals)
        return arr.reshape(shape)



# ---------------------------------------------------------------------------
# Evaluation entry point (SweepResult.derive lands here).
# ---------------------------------------------------------------------------


def evaluate(result, metric, baseline: dict | None = None,
             params: dict | None = None) -> np.ndarray:
    """Evaluate one metric over a labeled result grid, returning an array
    broadcastable to the grid's shape.  Relational metrics require
    ``baseline`` (an axis-selection dict, see
    ``SweepResult._baseline_view``); other kinds forbid it.  On-demand
    sub-metrics requested via ``ctx.counter`` are cached into
    ``result.data`` as a side effect.
    """
    m = get(metric)
    if m.params is not None and params:
        unknown = sorted(set(params) - set(m.params))
        if unknown:
            raise TypeError(
                f"metric {m.name!r} got unknown parameter(s) "
                f"{', '.join(unknown)}; accepts: "
                f"{', '.join(m.params) or '(none)'}")
    ctx = MetricContext(result, params, (m.name,))
    if m.kind == "relational":
        if baseline is None:
            raise ValueError(
                f"metric {m.name!r} is relational; pass baseline= "
                "(e.g. baseline=dict(capacity=32))")
        base = MetricContext(result._baseline_view(baseline), params,
                             (m.name,))
        return np.asarray(m.fn(ctx, base))
    if baseline is not None:
        raise ValueError(
            f"metric {m.name!r} is {m.kind}, not relational — baseline= "
            "does not apply")
    return np.asarray(m.fn(ctx))


# ---------------------------------------------------------------------------
# Built-in roofline metrics: pointwise counter algebra.
# ---------------------------------------------------------------------------


@register("arithmetic_intensity", "derived",
          "flops per instrumented HBM byte (flops / counted_bytes) — the "
          "measured x-coordinate of a roofline point",
          params=())
def _arithmetic_intensity(ctx):
    return ctx.counter("flops") / ctx.counter("counted_bytes")


@register("model_arithmetic_intensity", "derived",
          "flops per closed-form hbm_traffic_model byte "
          "(flops / model_bytes) — the model x-coordinate of a "
          "roofline point",
          params=())
def _model_arithmetic_intensity(ctx):
    return ctx.counter("flops") / ctx.counter("model_bytes")


@register("achieved_gflops", "derived",
          "measured compute throughput (flops / us_per_call / 1e3) — the "
          "y-coordinate of a roofline point",
          params=())
def _achieved_gflops(ctx):
    return ctx.counter("flops") / ctx.counter("us_per_call") / 1e3
