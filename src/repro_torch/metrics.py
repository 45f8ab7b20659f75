"""Metrics as an API: a declarative registry of derived quantities over
labeled :class:`repro_torch.api.SweepResult` grids.

A numpy copy of the reference's ``repro/metrics.py``, whole: every
headline number in the paper is a *derived* quantity, not a raw counter —
VRF/VPU/total area savings (Fig 2, §4.4.1), per-application power (Fig 8),
the equal-area narrow-VRF comparison (Fig 6), speedup over the full VRF
(Table 3).  A :class:`Metric` is a named, documented, composable function
over the counter grids of a ``SweepResult``, evaluated vectorized over the
whole grid at once.  Three kinds:

  * **derived** — pointwise counter algebra (``scaled_cycles``,
    ``spill_traffic_bytes``, ``l1_amat``, the roofline's
    ``arithmetic_intensity`` and ``achieved_gflops``);
  * **model** — the :mod:`repro_torch.core.costmodel` area/power/energy
    models evaluated over the grid, with the ``capacity`` axis as the
    register count and machine axes as latencies (``total_area``,
    ``application_power``, ``energy``, ``edp``, ``narrow_vrf_cycles``);
  * **relational** — quantities *relative to a baseline point* of the same
    sweep (``speedup``, ``savings_pct``, ``ratio``, ``delta``): they take
    an explicit ``baseline=`` axis selection and broadcast the baseline
    slice against the full grid (on a zipped ``config`` axis the unpinned
    fields are matched per point).

The registry is the extension point: :func:`register` adds a new metric,
and :mod:`repro_torch.silicon` registers its macro metrics that way,
loaded on the first lookup of an unknown name or catalog dump.  The
cluster metrics read ``meta["cluster"]`` and the serving metrics grids
built with ``SweepResult.from_table``; the port's ``Session`` makes
neither kind of grid yet (the cluster and the serving suites come later).
Evaluation is pure numpy on counters the sweep already produced —
deriving never runs the engine.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.api import _CONFIG_FIELDS, _GEOMETRY_FIELDS
from repro_torch.core import costmodel, isa

__all__ = [
    "Metric", "MetricContext", "register", "unregister", "get", "names",
    "evaluate", "area_headline", "KINDS",
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

_PLUGINS_LOADED = False


def _load_plugins() -> None:
    """Import the metric-registering plugin packages exactly once.

    ``repro_torch.silicon`` registers its macro-calibrated metrics
    (``silicon_area``, ``silicon_energy``, ...) through :func:`register`
    at import time — the no-core-edit extension path.  The import is lazy
    (first unknown-name lookup or catalog dump) so ``repro_torch.metrics``
    itself stays importable from the core without the plugin layers."""
    global _PLUGINS_LOADED
    if _PLUGINS_LOADED:
        return
    _PLUGINS_LOADED = True
    import repro_torch.silicon  # noqa: F401  (registers its metrics)


def register(name: str, kind: str, doc: str = "", override: bool = False,
             params: tuple | None = None):
    """Decorator registering a metric function under ``name``.

    ``kind`` is ``"derived"`` / ``"model"`` / ``"relational"``; ``doc``
    is the one-line description surfaced in ``run.py --json`` metadata;
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
        _load_plugins()
        try:
            return _REGISTRY[metric]
        except KeyError:
            raise KeyError(
                f"unknown metric {metric!r}; registered: "
                f"{', '.join(sorted(_REGISTRY))}") from None


def names() -> list[str]:
    """Sorted names of every registered metric."""
    _load_plugins()
    return sorted(_REGISTRY)


def catalog() -> dict[str, dict]:
    """JSON-safe registry dump: name -> {kind, doc} (for ``run.py --json``)."""
    _load_plugins()
    return {n: dict(kind=m.kind, doc=m.doc.strip().splitlines()[0]
                    if m.doc.strip() else "")
            for n, m in sorted(_REGISTRY.items())}


# ---------------------------------------------------------------------------
# Evaluation context.
# ---------------------------------------------------------------------------


class MetricContext:
    """What a metric function sees: the grid's counters, the axis values
    broadcast as grids, and the call's parameters.

    ``counter(name)`` returns the named counter array — or, when ``name``
    is itself a registered derived/model metric not yet in the data,
    evaluates it on demand so metrics compose.  The call's parameters
    propagate down the composition chain (``derive("energy", pp=...)``
    reaches ``application_power``); only parameter-free evaluations are
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

    @property
    def kernel_params(self):
        """The sweep's build-size selector (``"paper"``/``"reduced"``/dict)."""
        return self.result.meta.get("kernel_params", "paper")


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
# Built-in derived metrics: pointwise counter algebra.
# ---------------------------------------------------------------------------


@register("scaled_cycles", "derived",
          "cycles corrected for prefix truncation (cycles * event_scale; "
          "equal to cycles on folded/full runs)",
          params=())
def _scaled_cycles(ctx):
    return ctx.counter("cycles") * ctx.counter("event_scale")


@register("spill_traffic_bytes", "derived",
          "bytes moved by dispersion spill/fill traffic "
          "((spills + fills) * VLEN_BYTES)",
          params=())
def _spill_traffic(ctx):
    return (ctx.counter("spills") + ctx.counter("fills")) * isa.VLEN_BYTES


@register("l1_amat", "derived",
          "L1 average memory access time: (1 + l1_hit_cycles) + "
          "miss_rate * mem_latency, from the sweep's machine axes",
          params=())
def _l1_amat(ctx):
    hits = ctx.counter("l1_hits")
    misses = ctx.counter("l1_misses")
    acc = hits + misses
    with np.errstate(divide="ignore", invalid="ignore"):
        miss_rate = np.where(acc > 0, misses / np.maximum(acc, 1), 0.0)
    return (1.0 + ctx.axis_grid("l1_hit_cycles")
            + miss_rate * ctx.axis_grid("mem_latency"))


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


# ---------------------------------------------------------------------------
# Built-in model metrics: vectorized costmodel over the grid.
# ---------------------------------------------------------------------------


def _dispersed_grid(ctx):
    """(n_vregs, dispersed) grids for the cost models.  ``dispersed``
    defaults to "auto": any capacity below the architectural register
    count runs the dispersion mechanism (matches every paper study)."""
    cap = ctx.axis_grid("capacity")
    d = ctx.params.get("dispersed", "auto")
    if isinstance(d, str) and d == "auto":
        return cap, cap < isa.NUM_ARCH_VREGS
    return cap, np.broadcast_to(np.asarray(bool(d)), cap.shape)


def _area_component(ctx, key):
    cap, disp = _dispersed_grid(ctx)
    grids = costmodel.cpu_area_grid(
        cap, n_lanes=ctx.params.get("n_lanes", 8), dispersed=disp)
    return grids[key]


@register("vrf_area", "model",
          "cVRF register+routing area (au) at each point's capacity "
          "(costmodel.cpu_area_grid; dispersed='auto' below 32 regs)",
          params=("dispersed", "n_lanes"))
def _vrf_area(ctx):
    return _area_component(ctx, "vrf")


@register("vpu_area", "model",
          "whole-VPU area (au): VRF + coupling + ALU + dispersion overhead",
          params=("dispersed", "n_lanes"))
def _vpu_area(ctx):
    return _area_component(ctx, "vpu")


@register("total_area", "model",
          "CPU+VPU logic area (au), excluding L1 SRAM macros (as Fig 7)",
          params=("dispersed", "n_lanes"))
def _total_area(ctx):
    return _area_component(ctx, "total")


@register("area_with_l1", "model",
          "total_area plus the L1 data-cache SRAM macro from the sweep's "
          "l1_geometry axis — the Pareto-frontier area axis; macro_model "
          "selects a repro_torch.silicon backend (None = legacy constants, "
          "which the 'flop' backend reproduces bit-identically)",
          params=("dispersed", "n_lanes", "macro_model"))
def _area_with_l1(ctx):
    sram = costmodel.l1_sram_area(ctx.axis_grid("l1_sets"),
                                  ctx.axis_grid("l1_ways"),
                                  macro=ctx.params.get("macro_model"))
    return ctx.counter("total_area") + sram


@register("application_power", "model",
          "average application power (model units) from activity counters "
          "at each point's capacity (costmodel.application_power_grid)",
          params=("dispersed", "n_lanes", "pp"))
def _application_power(ctx):
    cap, disp = _dispersed_grid(ctx)
    return costmodel.application_power_grid(
        ctx.result.data, cap, n_lanes=ctx.params.get("n_lanes", 8),
        dispersed=disp, pp=ctx.params.get("pp", costmodel.DEFAULT_POWER),
    )["total"]


@register("energy", "model",
          "application energy (model units): application_power * "
          "scaled_cycles",
          params=("dispersed", "n_lanes", "pp"))
def _energy(ctx):
    return ctx.counter("application_power") * ctx.counter("scaled_cycles")


@register("edp", "model",
          "energy-delay product: energy * scaled_cycles",
          params=("dispersed", "n_lanes", "pp"))
def _edp(ctx):
    return ctx.counter("energy") * ctx.counter("scaled_cycles")


@register("scalar_cycles", "model",
          "analytic scalar-core cycles per kernel (ScalarCost at the "
          "sweep's build size and mem_latency axis) — Table 3's baseline",
          params=())
def _scalar_cycles(ctx):
    from repro_torch import rvv  # runtime import: kernels sit above the core
    kernels = ctx.axis_values("kernel")
    mems = ctx.axis_values("mem_latency")
    kp = ctx.kernel_params
    table = np.empty((len(kernels), len(mems)), np.float64)
    for ki, name in enumerate(kernels):
        bench = rvv.get_benchmark(name)
        kw = dict(bench.paper_params if kp == "paper"
                  else bench.reduced_params if kp == "reduced" else kp)
        sc = bench.scalar_cost(**kw)
        for mi, mem in enumerate(mems):
            from repro_torch.core.simulator import MachineParams
            table[ki, mi] = sc.cycles(MachineParams(mem_latency=int(mem)))
    axes = [a.name for a in ctx.result.axes]
    shape = [1] * len(axes)
    shape[axes.index("kernel")] = len(kernels)
    shape[axes.index("mem_latency")] = len(mems)
    return table.reshape(shape)


@register("scalar_speedup", "derived",
          "vector speedup over the analytic scalar core: scalar_cycles / "
          "scaled_cycles (Table 3)",
          params=())
def _scalar_speedup(ctx):
    return ctx.counter("scalar_cycles") / ctx.counter("scaled_cycles")


@register("narrow_vrf_cycles", "model",
          "Fig 6 equal-area narrow machine: cycles of a full-VRF core at "
          "VL/strip_factor, modelled from this point's counters and the "
          "sweep's machine axes (L1 access = 1 + l1_hit_cycles, miss adds "
          "mem_latency)",
          params=("strip_factor",))
def _narrow_vrf_cycles(ctx):
    """With VL/strip, every vector instruction strip-mines into ``strip``
    (strip x base occupancy and loop overhead) while each 32-byte line is
    touched by ``strip`` narrow accesses (1 miss + strip-1 extra hits per
    previously-missed line); the narrow VRF holds all 32 registers so it
    has no dispersion stalls."""
    strip = float(ctx.params.get("strip_factor", 4))
    hit_cost = 1.0 + ctx.axis_grid("l1_hit_cycles")
    miss_cost = hit_cost + ctx.axis_grid("mem_latency")
    l1_hits = np.asarray(ctx.counter("l1_hits"), np.float64)
    l1_miss = np.asarray(ctx.counter("l1_misses"), np.float64)
    mem_cycles = l1_hits * hit_cost + l1_miss * miss_cost
    compute_cycles = np.asarray(ctx.counter("cycles"), np.float64) \
        - mem_cycles
    naccess = (l1_hits + l1_miss) * strip
    return (strip * compute_cycles + (naccess - l1_miss) * hit_cost
            + l1_miss * miss_cost)


@register("narrow_vrf_speedup", "derived",
          "full-VRF cycles over the equal-area narrow machine's cycles at "
          "the same point (Fig 6's narrow_32x64 column)",
          params=("strip_factor",))
def _narrow_vrf_speedup(ctx):
    return ctx.counter("cycles") / ctx.counter("narrow_vrf_cycles")


# ---------------------------------------------------------------------------
# Cluster metrics: over grids with a ``cores`` axis (cluster sweeps).
# The shared-memory system (L2 geometry, channels) is uniform across the
# grid and rides on ``meta["cluster"]``; per-core quantities come from the
# existing axes (capacity, l1_geometry) times the ``cores`` axis.
# ---------------------------------------------------------------------------


def _cluster_meta(ctx) -> dict:
    cl = ctx.result.meta.get("cluster")
    if cl is None:
        raise KeyError(
            "no meta['cluster'] — this metric needs a cluster sweep "
            "(api.Sweep with a cores axis, run through Session.run)")
    return cl


@register("cluster_area", "model",
          "whole-cluster area (au): cores * (CPU+VPU logic + L1 macro) "
          "plus the shared-L2 SRAM macro from meta['cluster']; "
          "macro_model prices both macros through a repro_torch.silicon "
          "backend (None = legacy constants)",
          params=("dispersed", "n_lanes", "macro_model"))
def _cluster_area(ctx):
    cl = _cluster_meta(ctx)
    macro = ctx.params.get("macro_model")
    if macro is not None:
        from repro_torch import silicon  # lazy: plugin layer above the core
        model = silicon.get_macro_model(macro)
        l2_au = float(model.area(cl["l2_sets"] * cl["l2_ways"], 32 * 8)) \
            if cl["l2_bytes"] else 0.0
    else:
        l2_au = cl["l2_bytes"] * 8 * costmodel.SRAM_AU_PER_BIT \
            + (costmodel.SRAM_PERIPHERY_AU if cl["l2_bytes"] else 0.0)
    return ctx.axis_grid("cores") * ctx.counter("area_with_l1") + l2_au


@register("sram_budget_bytes", "model",
          "total storage the cluster holds: cores * (capacity * VLEN_BYTES "
          "+ L1 bytes) + shared-L2 bytes — the iso-budget axis of "
          "benchmarks/cluster_sweep.py",
          params=())
def _sram_budget_bytes(ctx):
    cl = _cluster_meta(ctx)
    l1_bytes = ctx.axis_grid("l1_sets") * ctx.axis_grid("l1_ways") * 32
    per_core = ctx.axis_grid("capacity") * isa.VLEN_BYTES + l1_bytes
    return ctx.axis_grid("cores") * per_core + cl["l2_bytes"]


@register("aggregate_throughput", "derived",
          "cluster-wide useful work rate: summed reg_writes per makespan "
          "cycle (reg_writes / scaled_cycles) — N perfectly scaling cores "
          "read N x the single-core value",
          params=())
def _aggregate_throughput(ctx):
    return ctx.counter("reg_writes") / ctx.counter("scaled_cycles")


@register("contention_stall_ratio", "derived",
          "fraction of total core-cycles spent queued on the shared "
          "memory channels (contention_stalls / core_cycles_sum); 0 on a "
          "passthrough or single-core cluster",
          params=())
def _contention_stall_ratio(ctx):
    stalls = np.asarray(ctx.counter("contention_stalls"), np.float64)
    total = np.asarray(ctx.counter("core_cycles_sum"), np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(total > 0, stalls / np.maximum(total, 1.0), 0.0)


# ---------------------------------------------------------------------------
# Built-in relational metrics: baseline-relative queries.
# ---------------------------------------------------------------------------


@register("speedup", "relational",
          "baseline cycles over this point's cycles (scaled_cycles, so "
          "truncated prefixes compare fairly); 1.0 at the baseline",
          params=())
def _speedup(ctx, base):
    return base.counter("scaled_cycles") / ctx.counter("scaled_cycles")


@register("ratio", "relational",
          "of= counter/metric at this point over its baseline value",
          params=("of",))
def _ratio(ctx, base):
    of = ctx.params["of"]
    return ctx.counter(of) / base.counter(of)


@register("savings_pct", "relational",
          "percent reduction of of= relative to the baseline: "
          "100 * (1 - x / x_baseline)",
          params=("of",))
def _savings_pct(ctx, base):
    of = ctx.params["of"]
    return 100.0 * (1.0 - ctx.counter(of) / base.counter(of))


@register("delta", "relational",
          "of= at this point minus its baseline value",
          params=("of",))
def _delta(ctx, base):
    of = ctx.params["of"]
    return ctx.counter(of) - base.counter(of)


@register("equal_area_advantage", "relational",
          "Fig 6 verdict: the equal-area narrow machine's cycles (from the "
          "baseline's counters) over this point's cycles — >1 means "
          "dispersion beats narrowing at equal area",
          params=("strip_factor",))
def _equal_area_advantage(ctx, base):
    return base.counter("narrow_vrf_cycles") / ctx.counter("cycles")


# ---------------------------------------------------------------------------
# Serving SLO metrics: over grids built with SweepResult.from_table from
# repro_torch.serve.slo.SLOReport rows (the serving_slo benchmark).
# ---------------------------------------------------------------------------


@register("slo_attainment", "derived",
          "fraction of admission attempts meeting their deadline: "
          "1 - deadline_miss_rate",
          params=())
def _slo_attainment(ctx):
    return 1.0 - ctx.counter("deadline_miss_rate")


@register("goodput", "derived",
          "SLO-weighted throughput: tokens_per_tick * slo_attainment "
          "(tokens that arrived in time, per virtual tick)",
          params=())
def _goodput(ctx):
    return ctx.counter("tokens_per_tick") * ctx.counter("slo_attainment")


@register("degraded_throughput_ratio", "derived",
          "throughput under active faults over overall throughput "
          "(degraded_tokens_per_tick / tokens_per_tick); ~1.0 means "
          "degradation was graceful, 0 means service stopped",
          params=())
def _degraded_throughput_ratio(ctx):
    tps = np.asarray(ctx.counter("tokens_per_tick"), np.float64)
    deg = np.asarray(ctx.counter("degraded_tokens_per_tick"), np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(tps > 0, deg / np.maximum(tps, 1e-12), 0.0)


# ---------------------------------------------------------------------------
# Standalone model queries (no sweep needed).
# ---------------------------------------------------------------------------


def area_headline(n_full: int = isa.NUM_ARCH_VREGS,
                  n_cvrf: int = 8) -> dict:
    """The Fig 2 / §4.4.1 headline rows as one model query: baseline
    breakdown percentages plus the three savings predictions (paper:
    61% / 43.4% / 3.5x / 53% / 23%)."""
    full = costmodel.cpu_area(n_full, dispersed=False)
    cvrf = costmodel.cpu_area(n_cvrf, dispersed=True)
    return dict(
        baseline_vrf_pct_of_vpu=100 * full.vrf / full.vpu,
        baseline_vpu_pct_of_total=100 * full.vpu / full.total,
        vrf_area_reduction_x=full.vrf / (cvrf.vrf
                                         + cvrf.dispersion_overhead),
        vpu_area_saving_pct=100 * (1 - cvrf.vpu / full.vpu),
        total_area_saving_pct=100 * (1 - cvrf.total / full.total),
    )
