"""One front door for the paper's design-space sweeps, on the card.

The port of the reference's ``repro/api.py``.  Every result in the paper
— Fig 4's capacity sweep, Table 3's speedups, the memory-system ablation —
is a point grid over the same named axes:

  ``kernel``        benchmark name from the :mod:`repro_torch.rvv` registry
  ``capacity``      physical registers in the compact VRF
  ``policy``        replacement policy (int constant or ``"fifo"``-style name)
  ``alloc_no_fetch``  beyond-paper write-allocate optimisation
  ``l1_geometry``   static L1 shape (:class:`L1Geometry`): each value is
                    its own engine call
  ``cores``         cluster size: N lockstep cores behind a shared L2
                    (with a :class:`repro_torch.cluster.ClusterConfig`
                    template, ``cluster``)
  ``mem_latency`` / ``l1_hit_cycles`` / ``uop_hit_cycles``
                    machine-latency axes, per-lane inputs of every call

A :class:`Sweep` declares values for those axes; a :class:`Session`
executes it.  ``Session.run`` plans one engine call per L1 geometry
(:func:`repro_torch.core.simulator.simulate_grid`: K1, the engine scan,
on the card; its plain twin with ``device="cpu"``; for a cluster sweep
:func:`repro_torch.cluster.simulate_clusters`, K1 then K2, the cluster
scan), with every kernel of the sweep, every ``cores`` value and the
whole latency grid in it, and refines each uncertified fold the
reference's way.  The result is a :class:`SweepResult` with
labeled axes, per-point counters and per-point ``fold_exact``
certificates, plus ``to_rows()`` / ``select()`` / ``value()`` accessors
and the metric algebra (``derive`` / ``normalize`` / ``pareto``,
evaluated by the :mod:`repro_torch.metrics` registry).

Where the port differs from the reference, on purpose:

  * the card is the default device (``Session(device="cuda")``) and a
    request for it without one raises; there is no fallback to the CPU;
  * K1 walks each program's own rows, so the plan has no shape buckets
    (the reference's padding buckets for XLA): its entries carry
    ``l1_geometry``, ``kernels`` and ``fused`` (and ``cores`` in a
    cluster sweep);
  * XLA's compile count has no counterpart: ``dispatch_count()`` counts
    the engine calls the Session made (refines included) and
    ``launch_count()`` the K1a/K1b/K2 launches they caused (0 on the
    CPU); a run's ``meta`` carries ``dispatches`` and ``launches``, no
    ``compiles``;
  * a cluster sweep makes one engine call per L1 geometry for all its
    ``cores`` values (K1 runs once for them: a core's single-core
    counters do not depend on the core count); its plan entries, one per
    (geometry, cores), name that call (``engine_call``).

The Session owns the caches: built kernels and prepared (expanded +
folded) traces.  Two Sessions share nothing.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from repro_torch.cluster import ClusterConfig, simulate_clusters
from repro_torch.core import folding, policies, simulator
from repro_torch.core.simulator import (DEFAULT_MACHINE, MachineSweep,
                                        SweepConfig)
from repro_torch.device import resolve_device
from repro_torch.kernels import cluster_scan as _k2
from repro_torch.kernels import engine_scan as _k1

__all__ = [
    "L1Geometry", "ConfigPoint", "Axis", "Sweep", "SweepResult", "Session",
    "default_session", "reset_default_session", "sweep_program",
    "REFINE_MAX_ROWS",
]

# A folded trace whose steadiness check fails is re-simulated in full when
# the full trace is affordable; bigger traces keep the (flagged) fold.
REFINE_MAX_ROWS = 400_000


# ---------------------------------------------------------------------------
# Axis value types.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class L1Geometry:
    """Static L1 data-cache shape: ``sets`` x ``ways`` lines of 32 bytes.

    These two fields size the engine's L1 state (K1b buckets accesses by
    set), so every distinct geometry is a separate engine call — which is
    why the planner treats this axis as its outer loop.
    """

    sets: int = 256
    ways: int = 2

    LINE_BYTES = 32

    @classmethod
    def from_kbytes(cls, kbytes: int, ways: int = 2) -> "L1Geometry":
        return cls(kbytes * 1024 // cls.LINE_BYTES // ways, ways)

    @property
    def kbytes(self) -> int:
        return self.sets * self.ways * self.LINE_BYTES // 1024

    def __str__(self) -> str:
        return f"{self.kbytes}KB/{self.ways}w"


@dataclasses.dataclass(frozen=True)
class ConfigPoint:
    """One zipped (capacity, policy, alloc_no_fetch) configuration point,
    for irregular grids the product axes cannot express (e.g. the policy
    headroom study's per-capacity FIFO+no-fetch extra column)."""

    capacity: int
    policy: int = policies.FIFO
    alloc_no_fetch: bool = False


_POLICY_BY_NAME = {v: k for k, v in policies.POLICY_NAMES.items()}


def _policy_id(p) -> int:
    if isinstance(p, str):
        try:
            return _POLICY_BY_NAME[p.lower()]
        except KeyError:
            raise ValueError(
                f"unknown policy {p!r}; available: "
                f"{', '.join(sorted(_POLICY_BY_NAME))}") from None
    return int(p)


def _as_geometry(g) -> L1Geometry:
    if isinstance(g, L1Geometry):
        return g
    if isinstance(g, tuple) and len(g) == 2:
        return L1Geometry(int(g[0]), int(g[1]))
    raise TypeError(
        f"l1_geometry values must be L1Geometry or (sets, ways) tuples, "
        f"got {g!r}")


def _as_config_point(c) -> ConfigPoint:
    if isinstance(c, ConfigPoint):
        return ConfigPoint(int(c.capacity), _policy_id(c.policy),
                           bool(c.alloc_no_fetch))
    if isinstance(c, dict):
        return _as_config_point(ConfigPoint(**c))
    if isinstance(c, (tuple, list)) and 1 <= len(c) <= 3:
        return _as_config_point(ConfigPoint(*c))
    raise TypeError(
        f"config_points entries must be ConfigPoint / (capacity, policy, "
        f"alloc_no_fetch) tuples / dicts, got {c!r}")


def _as_tuple(v) -> tuple:
    if isinstance(v, (str, bytes)):
        return (v,)
    try:
        return tuple(v)
    except TypeError:
        return (v,)


@dataclasses.dataclass(frozen=True)
class Axis:
    """One labeled sweep axis: a name and its ordered point values."""

    name: str
    values: tuple

    def __len__(self) -> int:
        return len(self.values)

    def indices(self, want) -> list[int]:
        """Positions of the requested value(s), normalised per axis type.
        Lists/sets/arrays always multi-select; tuples multi-select too,
        except on the ``config``/``l1_geometry`` axes where a tuple is one
        point."""
        multi = (list, set, np.ndarray)
        if self.name not in ("config", "l1_geometry"):
            multi += (tuple,)
        wants = list(want) if isinstance(want, multi) else [want]
        norm = {"policy": _policy_id, "l1_geometry": _as_geometry,
                "config": _as_config_point}.get(self.name, lambda v: v)
        idx = []
        for w in wants:
            w = norm(w)
            hits = [i for i, v in enumerate(self.values) if v == w]
            if not hits:
                raise ValueError(
                    f"axis {self.name!r} has no point {w!r}; values: "
                    f"{list(self.values)}")
            idx.extend(hits)
        return idx


# ---------------------------------------------------------------------------
# The declarative sweep spec.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Sweep:
    """A declarative design-space sweep over named axes.

    The config axes (``capacity`` x ``policy`` x ``alloc_no_fetch``) and the
    machine-latency axes (``mem_latency`` x ``l1_hit_cycles`` x
    ``uop_hit_cycles``) form full cartesian products; ``config_points``
    replaces the three config axes with one zipped ``config`` axis for
    irregular grids.  ``l1_geometry`` is the static outer axis the planner
    orchestrates (one engine call per geometry).

    ``kernel_params`` selects the build size: ``"paper"`` (default),
    ``"reduced"``, or a dict of build kwargs applied to every kernel.
    ``fold=None`` defers to the Session's fold policy.  ``max_events`` is
    the legacy truncation budget (forces ``fold`` off) — kept as an explicit
    escape hatch for smoke runs; prefer folding.

    ``cores`` and ``cluster`` add the cluster axis: N lockstep
    dispersion cores behind the shared L2 and memory channels of the
    ``cluster`` template (:class:`repro_torch.cluster.ClusterConfig`,
    default: no L2, one channel), run by the cluster engine; the result
    gains a ``cores`` axis after ``l1_geometry`` and the cluster counters,
    with ``cycles`` the makespan.

    ``network`` names models from :mod:`repro_torch.configs.registry`:
    each is lowered through :mod:`repro_torch.bridge` (layer shapes ->
    deduplicated ``net:*`` kernels, registered on first use) and the
    union of lowered kernels joins the ``kernel`` axis — so one
    ``Sweep(network=(...,))`` plans a whole model mix as a single planned
    run.  The lowered per-layer records ride on the result's
    ``meta["networks"]``; :func:`repro_torch.bridge.network_report`
    folds per-kernel counters back into per-model totals.
    """

    kernels: tuple[str, ...] = ()
    capacity: tuple[int, ...] = (8,)
    policy: tuple[int, ...] = (policies.FIFO,)
    alloc_no_fetch: tuple[bool, ...] = (False,)
    config_points: tuple[ConfigPoint, ...] | None = None
    mem_latency: tuple[int, ...] = (DEFAULT_MACHINE.mem_latency,)
    l1_hit_cycles: tuple[int, ...] = (DEFAULT_MACHINE.l1_hit_cycles,)
    uop_hit_cycles: tuple[int, ...] = (DEFAULT_MACHINE.uop_hit_cycles,)
    l1_geometry: tuple[L1Geometry, ...] = (
        L1Geometry(DEFAULT_MACHINE.l1_sets, DEFAULT_MACHINE.l1_ways),)
    kernel_params: str | dict = "paper"
    fold: bool | None = None
    max_events: int | None = None
    network: tuple[str, ...] = ()
    cores: tuple[int, ...] = (1,)
    cluster: object | None = None

    def __post_init__(self):
        fix = object.__setattr__
        fix(self, "network",
            tuple(_as_tuple(self.network)) if self.network else ())
        kernels = list(_as_tuple(self.kernels))
        lowered = ()
        if self.network:
            from repro_torch.bridge import lower_network
            lowered = tuple(lower_network(m) for m in self.network)
            for net in lowered:
                kernels += [k for k in net.kernels if k not in kernels]
        fix(self, "_lowered", lowered)    # companion record, not a field
        fix(self, "kernels", tuple(kernels))
        if not self.kernels:
            raise ValueError("Sweep needs at least one kernel name")
        fix(self, "capacity", tuple(int(c) for c in _as_tuple(self.capacity)))
        fix(self, "policy",
            tuple(_policy_id(p) for p in _as_tuple(self.policy)))
        fix(self, "alloc_no_fetch",
            tuple(bool(a) for a in _as_tuple(self.alloc_no_fetch)))
        if self.config_points is not None:
            fix(self, "config_points",
                tuple(_as_config_point(c)
                      for c in _as_tuple(self.config_points)))
        fix(self, "mem_latency",
            tuple(int(m) for m in _as_tuple(self.mem_latency)))
        fix(self, "l1_hit_cycles",
            tuple(int(m) for m in _as_tuple(self.l1_hit_cycles)))
        fix(self, "uop_hit_cycles",
            tuple(int(m) for m in _as_tuple(self.uop_hit_cycles)))
        fix(self, "l1_geometry",
            tuple(_as_geometry(g) for g in _as_tuple(self.l1_geometry)))
        fix(self, "cores", tuple(int(n) for n in _as_tuple(self.cores)))
        if any(n < 1 for n in self.cores):
            raise ValueError(f"cores values must be >= 1, got {self.cores}")
        if self.cluster is not None:
            if not isinstance(self.cluster, ClusterConfig):
                raise TypeError(
                    f"cluster must be a repro_torch.cluster.ClusterConfig, "
                    f"got {self.cluster!r}")

    @property
    def is_cluster(self) -> bool:
        """True when this sweep runs the cluster engine (a non-trivial
        ``cores`` axis or an explicit shared-memory ``cluster`` template)."""
        return self.cores != (1,) or self.cluster is not None

    def cluster_config(self, n_cores: int):
        """The :class:`repro_torch.cluster.ClusterConfig` for one ``cores``
        point: the ``cluster`` template with its ``n_cores`` overridden
        (default template: no shared L2, one memory channel)."""
        base = self.cluster if self.cluster is not None else ClusterConfig()
        return dataclasses.replace(base, n_cores=int(n_cores))

    # -- derived engine inputs -------------------------------------------

    def config(self) -> SweepConfig:
        """The flattened (C,) config axis of the engine's lanes."""
        if self.config_points is not None:
            return SweepConfig(
                np.asarray([c.capacity for c in self.config_points],
                           np.int32),
                np.asarray([c.policy for c in self.config_points], np.int32),
                np.asarray([c.alloc_no_fetch for c in self.config_points],
                           bool))
        return SweepConfig.product(self.capacity, self.policy,
                                   self.alloc_no_fetch)

    def machine_sweep(self, geometry: L1Geometry) -> MachineSweep:
        """The (M,) latency grid bound to one static geometry."""
        return MachineSweep.product(
            self.mem_latency, self.l1_hit_cycles, self.uop_hit_cycles,
            l1_sets=geometry.sets, l1_ways=geometry.ways)

    def axes(self) -> tuple[Axis, ...]:
        """The labeled result axes, in canonical (row-major) order."""
        if self.config_points is not None:
            cfg_axes = (Axis("config", self.config_points),)
        else:
            cfg_axes = (Axis("capacity", self.capacity),
                        Axis("policy", self.policy),
                        Axis("alloc_no_fetch", self.alloc_no_fetch))
        core_axes = (Axis("cores", self.cores),) if self.is_cluster else ()
        return ((Axis("kernel", self.kernels),) + cfg_axes
                + (Axis("l1_geometry", self.l1_geometry),) + core_axes
                + (Axis("mem_latency", self.mem_latency),
                   Axis("l1_hit_cycles", self.l1_hit_cycles),
                   Axis("uop_hit_cycles", self.uop_hit_cycles)))


# ---------------------------------------------------------------------------
# The labeled result grid.
# ---------------------------------------------------------------------------


_CONFIG_FIELDS = ("capacity", "policy", "alloc_no_fetch")
# Row-field name -> L1Geometry attribute, shared with repro_torch.metrics'
# axis_grid so label expansion and metric grids can never disagree.
_GEOMETRY_FIELDS = {"l1_sets": "sets", "l1_ways": "ways", "l1_kb": "kbytes"}


@dataclasses.dataclass
class SweepResult:
    """Counter grids over labeled axes.

    ``data`` maps counter name -> ndarray shaped like the axes (for an
    engine sweep, in :meth:`Sweep.axes` order: the engine counters,
    ``hit_rate``, ``event_scale`` and the per-point ``fold_exact``
    certificate; for a table such as the roofline's: its measured
    fields).  ``fold_exact`` certifies the periodic-fold extrapolation
    only — it is vacuously True for unfolded points, including
    ``max_events``-truncated smoke runs, whose scaled-prefix approximation
    is flagged by ``event_scale > 1`` instead.  ``meta`` records the
    execution plan and history, e.g. the metrics ``derive`` evaluated.
    """

    axes: tuple[Axis, ...]
    data: dict[str, np.ndarray]
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(len(a) for a in self.axes)

    @classmethod
    def from_table(cls, axes: dict, rows: list[dict], values=None,
                   meta: dict | None = None) -> "SweepResult":
        """Assemble a labeled grid from flat result rows.

        ``axes`` is an ordered {name: values} mapping; every row must carry
        each axis name (its value locating the row on the grid) plus the
        measured fields.  ``values`` names the fields to grid (default:
        every non-axis key of the first row).  Missing grid points read
        NaN.  This is how non-simulator sweeps (e.g. the serving SLO
        benchmark) ride the same ``select``/``pareto``/``derive`` surface
        as the cVRF grids.
        """
        ax = tuple(Axis(n, tuple(_as_tuple(v))) for n, v in axes.items())
        if not rows:
            raise ValueError("from_table needs at least one row")
        names = [a.name for a in ax]
        if values is None:
            values = [k for k in rows[0] if k not in names]
        shape = tuple(len(a) for a in ax)
        data = {k: np.full(shape, np.nan) for k in values}
        lookup = [{v: i for i, v in enumerate(a.values)} for a in ax]
        for row in rows:
            try:
                idx = tuple(lk[row[a.name]]
                            for a, lk in zip(ax, lookup))
            except KeyError as e:
                raise ValueError(
                    f"row {row!r} has no grid point for axis value "
                    f"{e.args[0]!r}") from None
            for k in values:
                data[k][idx] = float(row[k])
        return cls(ax, data, meta if meta is not None else {})

    def keys(self):
        return self.data.keys()

    def __getitem__(self, counter: str) -> np.ndarray:
        return self.data[counter]

    def axis(self, name: str) -> Axis:
        for a in self.axes:
            if a.name == name:
                return a
        raise KeyError(f"no axis {name!r}; axes: "
                       f"{[a.name for a in self.axes]}")

    # -- accessors --------------------------------------------------------

    def _resolve(self, key, want) -> tuple[int, list[int]]:
        names = [a.name for a in self.axes]
        if key in names:
            ai = names.index(key)
            return ai, self.axes[ai].indices(want)
        if key in _CONFIG_FIELDS and "config" in names:
            ai = names.index("config")
            axis = self.axes[ai]
            wants = list(want) if isinstance(
                want, (list, tuple, set, np.ndarray)) else [want]
            if key == "policy":
                wants = [_policy_id(w) for w in wants]
            idx = [i for i, c in enumerate(axis.values)
                   if getattr(c, key) in wants]
            if not idx:
                raise ValueError(
                    f"no config point with {key}={want!r}; points: "
                    f"{list(axis.values)}")
            return ai, idx
        raise KeyError(f"unknown axis {key!r}; axes: {names}")

    def select(self, **sel) -> "SweepResult":
        """Filter axes by value (scalar keeps a length-1 axis; a list keeps
        the listed points).  With a zipped ``config`` axis, ``capacity`` /
        ``policy`` / ``alloc_no_fetch`` filter by field.  Views share the
        sweep's ``meta``, so ``derive`` on any view records into the same
        execution history entry."""
        r = self
        for key, want in sel.items():
            ai, idx = r._resolve(key, want)       # against the narrowed axes
            axes = list(r.axes)
            axes[ai] = Axis(axes[ai].name,
                            tuple(axes[ai].values[i] for i in idx))
            r = SweepResult(
                tuple(axes),
                {k: np.take(v, idx, axis=ai) for k, v in r.data.items()},
                self.meta)
        return r

    def value(self, counter: str, **sel):
        """The single scalar at a fully determined point."""
        r = self.select(**sel) if sel else self
        arr = r.data[counter]
        if arr.size != 1:
            raise ValueError(
                f"selection leaves {arr.size} points for {counter!r} "
                f"(shape {r.shape}); pin every multi-valued axis")
        return arr.reshape(())[()].item()

    def array(self, counter: str, **sel) -> np.ndarray:
        """Counter values for a selection, singleton axes squeezed away."""
        r = self.select(**sel) if sel else self
        return np.squeeze(r.data[counter])

    def to_grid(self, **sel) -> dict[str, np.ndarray]:
        """The legacy (P, C, M) engine view — kernels x flattened configs x
        flattened machine-latency points — for one L1 geometry (select a
        geometry first when the sweep has several).  This is the shape
        the cost model's machine-affinity check consumes."""
        r = self.select(**sel) if sel else self
        geo = r.axis("l1_geometry")
        if len(geo) != 1:
            raise ValueError(
                "to_grid needs a single L1 geometry; select one of "
                f"{list(geo.values)} first")
        p = len(r.axes[0])
        m = math.prod(len(r.axis(n)) for n in
                      ("mem_latency", "l1_hit_cycles", "uop_hit_cycles"))
        c = math.prod(len(a) for a in r.axes) // (p * m)
        return {k: np.ascontiguousarray(v).reshape(p, c, m)
                for k, v in r.data.items()}

    def _labels(self, idx) -> dict:
        """Axis labels of one grid point, expanded to scalar fields."""
        row = {}
        for a, i in zip(self.axes, idx):
            v = a.values[i]
            if a.name == "config":
                row.update(capacity=v.capacity, policy=v.policy,
                           alloc_no_fetch=v.alloc_no_fetch)
                row["policy_name"] = policies.POLICY_NAMES[v.policy]
            elif a.name == "policy":
                row["policy"] = v
                row["policy_name"] = policies.POLICY_NAMES[v]
            elif a.name == "l1_geometry":
                row["l1_geometry"] = str(v)
                row.update({f: getattr(v, attr)
                            for f, attr in _GEOMETRY_FIELDS.items()})
            else:
                row[a.name] = v
        return row

    def to_rows(self, counters=None) -> list[dict]:
        """One dict per grid point: every axis label (config points and
        geometries expanded into scalar fields) plus the counters."""
        counters = list(counters) if counters is not None \
            else list(self.data)
        rows = []
        for idx in np.ndindex(*self.shape):
            row = self._labels(idx)
            for k in counters:
                row[k] = self.data[k][idx].item()
            rows.append(row)
        return rows

    def quantile(self, q: float, over: str) -> "SweepResult":
        """Collapse the ``over`` axis to its q-th percentile (0..100),
        counter by counter — e.g. ``result.quantile(99, over="seed")``
        turns a per-seed grid into a p99 grid.  The collapsed axis is
        removed from the result."""
        names = [a.name for a in self.axes]
        if over not in names:
            raise KeyError(f"no axis {over!r}; axes: {names}")
        ai = names.index(over)
        axes = tuple(a for a in self.axes if a.name != over)
        data = {k: np.percentile(v, q, axis=ai)
                for k, v in self.data.items()}
        return SweepResult(axes, data, self.meta)

    # -- the metric algebra (repro_torch.metrics evaluates; this owns the
    # axes) --

    def _baseline_view(self, baseline: dict) -> "SweepResult":
        """The baseline-aligned view of this grid, broadcastable against
        it: every product axis named in ``baseline`` is pinned to exactly
        one point (kept as a length-1 axis); on a zipped ``config`` axis,
        ``capacity``/``policy``/``alloc_no_fetch`` keys pin *fields* and
        each config point is aligned to the point sharing its remaining
        fields (e.g. ``baseline=dict(policy="fifo")`` maps every (cap,
        pol) point to (cap, FIFO))."""
        if not isinstance(baseline, dict) or not baseline:
            raise TypeError("baseline must be a non-empty dict of axis "
                            "selections, e.g. dict(capacity=32)")
        names = [a.name for a in self.axes]
        r = self
        pins = {}
        for key, want in baseline.items():
            if key in names:
                r = r.select(**{key: want})
                if len(r.axis(key)) != 1:
                    raise ValueError(
                        f"baseline {key}={want!r} selects "
                        f"{len(r.axis(key))} points; pin exactly one")
            elif key in _CONFIG_FIELDS and "config" in names:
                pins[key] = _policy_id(want) if key == "policy" else want
            else:
                raise KeyError(
                    f"unknown baseline axis {key!r}; axes: {names}")
        if pins:
            ai = names.index("config")
            pts = r.axis("config").values
            first = {}
            for j, c in enumerate(pts):
                first.setdefault((c.capacity, c.policy, c.alloc_no_fetch),
                                 j)
            idx = []
            for c in pts:
                tgt = tuple(pins.get(f, getattr(c, f))
                            for f in _CONFIG_FIELDS)
                if tgt not in first:
                    raise ValueError(
                        f"no baseline config point "
                        f"{dict(zip(_CONFIG_FIELDS, tgt))} to align "
                        f"{c} against")
                idx.append(first[tgt])
            axes = list(r.axes)
            axes[ai] = Axis("config", tuple(pts[j] for j in idx))
            r = SweepResult(
                tuple(axes),
                {k: np.take(v, idx, axis=ai) for k, v in r.data.items()},
                self.meta)
        return r

    def derive(self, metric, baseline: dict | None = None,
               out: str | None = None, **params) -> "SweepResult":
        """Evaluate a registered :mod:`repro_torch.metrics` metric over the
        whole grid and return a new result carrying it as an extra labeled
        counter (under ``out`` or the metric's name).  Relational metrics
        require ``baseline=`` (an axis-selection dict); extra keyword
        arguments are metric parameters.  Sub-metrics the evaluation pulls
        in via ``ctx.counter`` ride along in the returned data.  Deriving
        is pure counter algebra — it never runs the engine."""
        from repro_torch import metrics as _metrics
        m = _metrics.get(metric)
        r = SweepResult(self.axes, dict(self.data), self.meta)
        arr = _metrics.evaluate(r, m, baseline=baseline, params=params)
        r.data[out or m.name] = np.broadcast_to(
            np.asarray(arr), self.shape).copy()
        record = dict(metric=m.name, kind=m.kind, out=out or m.name)
        if baseline is not None:
            record["baseline"] = {k: str(v) for k, v in baseline.items()}
        if params:
            record["params"] = {k: str(v) for k, v in params.items()}
        derived = self.meta.setdefault("derived", [])
        if record not in derived:
            derived.append(record)
        return r

    def normalize(self, counter: str, baseline: dict) -> "SweepResult":
        """Return a copy with ``counter`` divided by its value at the
        ``baseline`` selection (broadcast; the baseline points read 1.0).
        Other counters are untouched."""
        base = self._baseline_view(baseline)
        r = SweepResult(self.axes, dict(self.data), self.meta)
        r.data[counter] = self.data[counter] / base.data[counter]
        return r

    def pareto(self, x: str | None = None, y: str | None = None,
               axes: list | tuple | None = None, maximize: tuple = (),
               **sel) -> list[dict]:
        """The maximal (non-dominated) front over N objectives across every
        point of the (optionally ``select``-narrowed) grid.

        Objectives come either as the classic two-objective sugar
        ``pareto(x, y)`` or as ``pareto(axes=["area", "cycles",
        "energy"])`` — the two forms are exclusive and ``pareto(x, y)``
        is exactly ``pareto(axes=[x, y])``.  Every objective is minimized
        unless named in ``maximize``; objectives may be counters or
        registered non-relational metrics (derived on demand).  A point is
        dominated when some other point is no worse on every objective and
        strictly better on at least one; exact ties on all objectives keep
        both points (so duplicates survive, as in the original
        two-objective implementation).

        Dominance is resolved with a lexicographic sort + incremental
        front (only lexicographically earlier points can dominate, and any
        dominator is itself dominated only by earlier front members), so
        the scan is one vectorized comparison per point against the
        growing front instead of the old all-pairs Python loop.

        Returns the non-dominated points as label rows (axis labels
        expanded, plus the objective values), sorted ascending by the
        tuple of raw objective values (for two objectives: ascending
        ``x``, then ``y`` — the original ordering).
        """
        if axes is None:
            if x is None or y is None:
                raise TypeError(
                    "pareto needs either positional x and y or "
                    "axes=[obj1, obj2, ...]")
            objectives = [x, y]
        else:
            if x is not None or y is not None:
                raise TypeError("pass either (x, y) or axes=, not both")
            objectives = list(axes)
        if len(objectives) < 2:
            raise ValueError(
                f"pareto needs at least 2 objectives, got {objectives!r}")
        if isinstance(maximize, str):
            maximize = (maximize,)
        unknown = sorted(set(maximize) - set(objectives))
        if unknown:
            raise ValueError(
                f"maximize names {unknown} are not objectives "
                f"{objectives}")
        r = self.select(**sel) if sel else self
        for m in objectives:
            if m not in r.data:
                r = r.derive(m)
        vals = np.stack([np.asarray(r.data[m], np.float64).ravel()
                         for m in objectives])          # (N_obj, K) raw
        signs = np.array([-1.0 if m in maximize else 1.0
                          for m in objectives])
        obj = vals * signs[:, None]                     # minimize all
        npts = obj.shape[1]
        # lexsort's last key is primary -> sort by obj0, then obj1, ...
        order = np.lexsort(obj[::-1])
        fv = np.empty((npts, len(objectives)))
        nf = 0
        front = []
        for k in order:
            p = obj[:, k]
            if nf:
                le = (fv[:nf] <= p).all(axis=1)
                lt = (fv[:nf] < p).any(axis=1)
                if bool(np.any(le & lt)):
                    continue
            fv[nf] = p
            nf += 1
            front.append(int(k))
        rows = []
        for k in front:
            idx = tuple(int(v) for v in np.unravel_index(k, r.shape))
            row = r._labels(idx)
            for oi, m in enumerate(objectives):
                row[m] = vals[oi, k].item()
            rows.append(row)
        rows.sort(key=lambda rr: tuple(rr[m] for m in objectives))
        return rows


# ---------------------------------------------------------------------------
# The session: cache owner + execution planner.
# ---------------------------------------------------------------------------

# The engine's kernels on the card, by name: K1a, K1b and K2
_ENGINE_KERNELS = {"engine_reg": _k1.engine_reg_cuda,
                   "engine_l1": _k1.engine_l1_cuda,
                   "cluster_l2": _k2.cluster_l2_cuda}


def _engine_launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in _ENGINE_KERNELS.items()}


class Session:
    """Owns every sweep-side cache and executes :class:`Sweep` specs.

    * *built* kernels, keyed (name, build params);
    * *prepared* traces (expanded + folded / truncated), keyed (name,
      params, fold, max_events, fold warm-up — a function of the static L1
      geometry only);
    * the fold / refine policy (``refine`` transparently re-simulates
      uncertified folds without folding when the full trace is affordable);
    * accounting for every engine call it issued: ``dispatch_count()``
      (``simulate_grid`` and ``simulate_clusters`` calls),
      ``launch_count()`` (K1a, K1b and K2 launches on the card), and the
      host seconds spent preparing traces and in engine calls
      (``prepare_seconds()``, ``engine_seconds()``).

    ``device`` is where the engine runs: ``"cuda"`` (the default) launches
    K1 and raises without a card; ``"cpu"`` runs K1's plain twin.
    ``batch_programs=None`` picks the device's default: one fused call for
    every program of a geometry on the card, one program at a time on the
    CPU (the twin walks each program's rows itself, so nothing is gained
    by batching there).
    """

    def __init__(self, fold: bool = True, refine: bool = True,
                 refine_max_rows: int = REFINE_MAX_ROWS,
                 batch_programs: bool | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.fold = fold
        self.refine = refine
        self.refine_max_rows = refine_max_rows
        if batch_programs is None:
            batch_programs = self.device.type == "cuda"
        self.batch_programs = batch_programs
        self.history: list[dict] = []
        self._built: dict = {}
        self._prepared: dict = {}
        self._reset_counts()

    def _reset_counts(self) -> None:
        self._dispatches = 0
        self._launches = dict.fromkeys(_ENGINE_KERNELS, 0)
        self._prepare_s = 0.0
        self._engine_s = 0.0

    # -- caches -----------------------------------------------------------

    @staticmethod
    def _build_params(bench, params):
        if params == "paper":
            return dict(bench.paper_params)
        if params == "reduced":
            return dict(bench.reduced_params)
        if isinstance(params, dict):
            return dict(params)
        raise ValueError(
            f"kernel_params must be 'paper', 'reduced' or a dict of build "
            f"kwargs, got {params!r}")

    def built(self, name: str, params: str | dict = "paper"):
        """Build (and cache) one benchmark kernel at the requested size."""
        from repro_torch import rvv
        bench = rvv.get_benchmark(name)
        kw = self._build_params(bench, params)
        key = (name, tuple(sorted(kw.items())))
        if key not in self._built:
            self._built[key] = bench.build(**kw)
        return self._built[key]

    def prepared(self, name: str, fold: bool | None = None,
                 max_events: int | None = None,
                 machine=DEFAULT_MACHINE,
                 params: str | dict = "paper") -> simulator.PreparedTrace:
        """Expanded (+folded / truncated) trace per benchmark, cached.

        The fold warm-up is a function of the static L1 geometry only
        (``machine.l1_sets`` / ``l1_ways``), so it is part of the cache key;
        the latency values never are.
        """
        from repro_torch import rvv
        if fold is None:
            fold = self.fold
        if max_events is not None:
            fold = False                  # truncation is the legacy mode
        warm = folding.warm_lines_for(machine.l1_sets, machine.l1_ways)
        kw = self._build_params(rvv.get_benchmark(name), params)
        # Unfolded preparations never read the warm-up, so they are shared
        # across L1 geometries instead of duplicated per geometry.
        key = (name, tuple(sorted(kw.items())), fold, max_events,
               warm if fold else None)
        if key not in self._prepared:
            program = self.built(name, params).program
            t0 = time.perf_counter()
            self._prepared[key] = simulator.prepare(
                program, fold=fold, max_events=max_events, warm_lines=warm)
            self._prepare_s += time.perf_counter() - t0
        return self._prepared[key]

    def reset(self) -> None:
        """Drop every cache and counter."""
        self._built.clear()
        self._prepared.clear()
        self.history.clear()
        self._reset_counts()

    # -- accounting -------------------------------------------------------

    def dispatch_count(self) -> int:
        """Engine calls (``simulate_grid``, ``simulate_clusters``) this
        session issued."""
        return self._dispatches

    def launch_count(self) -> dict[str, int]:
        """K1a (``engine_reg``), K1b (``engine_l1``) and K2
        (``cluster_l2``) launches this session's engine calls made (0 on
        the CPU)."""
        return dict(self._launches)

    def prepare_seconds(self) -> float:
        """Host seconds this session spent preparing traces."""
        return self._prepare_s

    def engine_seconds(self) -> float:
        """Host seconds this session spent in engine calls, the device's
        work included (each call returns its counters on the host)."""
        return self._engine_s

    def _counted(self, engine, *args, **kw):
        """One engine call, with its seconds, dispatch and launches
        counted."""
        l0 = _engine_launches()
        t0 = time.perf_counter()
        out = engine(*args, batch_programs=self.batch_programs,
                     device=self.device, **kw)
        self._engine_s += time.perf_counter() - t0
        self._dispatches += 1
        for name, n in _engine_launches().items():
            self._launches[name] += n - l0[name]
        return out

    def _simulate(self, preps, config, machine):
        return self._counted(simulator.simulate_grid, preps, config,
                             machine)

    def _simulate_cluster(self, preps, config, machine, clusters):
        """One cluster-engine call for every cluster point of
        ``clusters`` (one per ``cores`` value), with the accounting of
        :meth:`_simulate`: one dispatch, K1 shared by the points."""
        return self._counted(simulate_clusters, preps, config, machine,
                             clusters)

    def _refine(self, names, out, config, machine, params) -> None:
        """Re-simulate, in place, every program whose fold certificate
        failed at any grid point and whose full trace is affordable."""
        if "fold_exact" not in out:
            return
        for pi, name in enumerate(names):
            if out["fold_exact"][pi].all():
                continue
            rows = self.built(name, params).program.num_instructions
            if rows > self.refine_max_rows:
                continue
            sub = self._simulate(
                [self.prepared(name, fold=False, machine=machine,
                               params=params)], config, machine)
            for k in out:
                out[k][pi] = sub[k][0] if k != "fold_exact" else True

    def _refine_cluster(self, names, out, config, machine, sweep) -> None:
        """Cluster analogue of :meth:`_refine`: re-simulate, unfolded and
        per failing ``cores`` point, every program whose cluster fold
        certificate failed (the shared L2 can break a period alignment
        that holds single-core, so certificates are per (kernel, cores))."""
        if "fold_exact" not in out:
            return
        for pi, name in enumerate(names):
            if out["fold_exact"][pi].all():
                continue
            rows = self.built(
                name, sweep.kernel_params).program.num_instructions
            if rows > self.refine_max_rows:
                continue
            prep = self.prepared(name, fold=False, machine=machine,
                                 params=sweep.kernel_params)
            for ki, n in enumerate(sweep.cores):
                if out["fold_exact"][pi, ki].all():
                    continue
                (sub,) = self._simulate_cluster(
                    [prep], config, machine, [sweep.cluster_config(n)])
                for k in out:
                    out[k][pi, ki] = sub[k][0] if k != "fold_exact" \
                        else True

    # -- execution --------------------------------------------------------

    def grid(self, names, config: SweepConfig, machine=DEFAULT_MACHINE,
             fold: bool | None = None, max_events: int | None = None,
             refine: bool | None = None,
             params: str | dict = "paper") -> dict[str, np.ndarray]:
        """The legacy-shaped sweep call: P named kernels x a flat (C,)
        config axis (x M machine points when ``machine`` is a
        :class:`MachineSweep`), returning raw counter arrays.  Prefer
        :meth:`run` with a declarative :class:`Sweep`; this is the engine
        room it and the ``benchmarks.common`` shim share.
        """
        if fold is None:
            fold = self.fold
        if refine is None:
            refine = self.refine
        names = list(names)
        preps = [self.prepared(n, fold=fold, max_events=max_events,
                               machine=machine, params=params)
                 for n in names]
        out = self._simulate(preps, config, machine)
        if fold and refine:
            self._refine(names, out, config, machine, params)
        return out

    def run(self, sweep: Sweep) -> SweepResult:
        """Execute a declarative sweep.

        Planning: one engine call per L1 geometry with every kernel of
        the sweep in it (fused into one K1 call on the card, program by
        program on the CPU) and the whole latency grid riding along;
        uncertified folds are then refined per geometry exactly as
        :meth:`grid` does, one more engine call per refined program.

        Cluster sweeps (:attr:`Sweep.is_cluster`) put every ``cores``
        value in that one call (K1 once, then K2 per cluster point);
        the plan gets one entry per (geometry, cores), each naming its
        ``engine_call``, uncertified folds are refined per (kernel,
        cores), and the result grid gains the cluster counters with
        ``cycles`` as the cluster makespan and ``meta["cluster"]``.
        """
        fold = self.fold if sweep.fold is None else sweep.fold
        if sweep.max_events is not None:
            fold = False
        names = list(sweep.kernels)
        config = sweep.config()
        d0, l0 = self._dispatches, dict(self._launches)
        p0, e0 = self._prepare_s, self._engine_s
        cluster_mode = sweep.is_cluster
        plan = []
        per_geo = []
        for gi, geo in enumerate(sweep.l1_geometry):
            machines = sweep.machine_sweep(geo)
            preps = [self.prepared(n, fold=fold,
                                   max_events=sweep.max_events,
                                   machine=machines,
                                   params=sweep.kernel_params)
                     for n in names]
            entry = dict(l1_geometry=str(geo), kernels=list(names),
                         fused=bool(self.batch_programs))
            if cluster_mode:
                subs = self._simulate_cluster(
                    preps, config, machines,
                    [sweep.cluster_config(n) for n in sweep.cores])
                plan += [dict(entry, cores=n, engine_call=gi)
                         for n in sweep.cores]
                out = {k: np.stack([s[k] for s in subs], axis=1)
                       for k in subs[0]}             # (P, K, C, M)
            else:
                out = self._simulate(preps, config, machines)
                plan.append(entry)
            out.setdefault("fold_exact", np.ones(out["cycles"].shape, bool))
            if fold and self.refine:
                if cluster_mode:
                    self._refine_cluster(names, out, config, machines,
                                         sweep)
                else:
                    self._refine(names, out, config, machines,
                                 sweep.kernel_params)
            per_geo.append(out)
        axes = sweep.axes()
        if sweep.config_points is not None:
            cshape = (len(sweep.config_points),)
        else:
            cshape = (len(sweep.capacity), len(sweep.policy),
                      len(sweep.alloc_no_fetch))
        mshape = (len(sweep.mem_latency), len(sweep.l1_hit_cycles),
                  len(sweep.uop_hit_cycles))
        data = {}
        for k in per_geo[0]:
            if cluster_mode:
                # (G, P, K, C, M) -> geometry and cores move to their
                # canonical slots after the config axes.
                stacked = np.stack([g[k] for g in per_geo])
                g, p, kc = stacked.shape[:3]
                stacked = stacked.reshape((g, p, kc) + cshape + mshape)
                data[k] = np.moveaxis(
                    stacked, (0, 2), (1 + len(cshape), 2 + len(cshape)))
            else:
                stacked = np.stack([g[k] for g in per_geo])  # (G, P, C, M)
                g, p = stacked.shape[:2]
                stacked = stacked.reshape((g, p) + cshape + mshape)
                # geometry moves to its canonical slot: after the config
                # axes.
                data[k] = np.moveaxis(stacked, 0, 1 + len(cshape))
        meta = dict(
            plan=plan,
            dispatches=self._dispatches - d0,
            launches={k: n - l0[k] for k, n in self._launches.items()},
            device=str(self.device),
            prepare_s=self._prepare_s - p0,
            engine_s=self._engine_s - e0,
            points=int(np.prod([len(a) for a in axes])),
            axes={a.name: [str(v) if a.name in ("l1_geometry", "config")
                           else v for v in a.values] for a in axes},
            kernel_params=(sweep.kernel_params
                           if isinstance(sweep.kernel_params, str)
                           else dict(sweep.kernel_params)),
            fold=fold,
        )
        if cluster_mode:
            cl0 = sweep.cluster_config(1)
            meta["cluster"] = dict(
                cores=list(sweep.cores), l2_sets=cl0.l2_sets,
                l2_ways=cl0.l2_ways, mem_channels=cl0.mem_channels,
                l2_hit_cycles=cl0.l2_hit_cycles, l2_bytes=cl0.l2_bytes)
        lowered = getattr(sweep, "_lowered", ())
        if lowered:
            meta["networks"] = [net.summary() for net in lowered]
        self.history.append(meta)
        return SweepResult(axes, data, meta)


# ---------------------------------------------------------------------------
# Process-default session + the raw-program front door.
# ---------------------------------------------------------------------------


_DEFAULT_SESSION: Session | None = None


def default_session() -> Session:
    """The process-default Session the benchmark layer shares (on the
    card: ``Session()``)."""
    global _DEFAULT_SESSION
    if _DEFAULT_SESSION is None:
        _DEFAULT_SESSION = Session()
    return _DEFAULT_SESSION


def reset_default_session(**session_kw) -> Session:
    """Replace the process-default Session with a fresh one, made with
    ``session_kw`` (for example ``device="cpu"``)."""
    global _DEFAULT_SESSION
    _DEFAULT_SESSION = Session(**session_kw)
    return _DEFAULT_SESSION


def sweep_program(program_or_events, config: SweepConfig,
                  machine=DEFAULT_MACHINE, fold: bool = False,
                  max_events: int | None = None,
                  device="cuda") -> dict[str, np.ndarray]:
    """Sweep one raw Program / EventStream / PreparedTrace over a flat
    config axis — the front door for traces that are not registered
    kernels (the deprecated ``simulator.simulate_sweep`` delegates here).
    Returns (C,)-shaped counter arrays, (C, M)-shaped under a
    :class:`MachineSweep`."""
    prep = simulator.prepare(program_or_events, fold=fold,
                             max_events=max_events, machine=machine)
    out = simulator.simulate_grid([prep], config, machine, device=device)
    return {k: v[0] for k, v in out.items()}
