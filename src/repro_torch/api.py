"""Labeled result grids for the port's sweeps (the part of
``repro/api.py`` that the measured roofline uses).

A numpy copy of the reference's axis value types (:class:`L1Geometry`,
:class:`ConfigPoint`, :class:`Axis`) and of :class:`SweepResult` whole:
``from_table``, ``select``, ``value``, ``to_rows``, ``quantile``, and the
metric algebra ``derive`` / ``normalize`` / N-objective ``pareto``, which
:mod:`repro_torch.metrics` evaluates.  The reference module imports its
cycle engine, which the port has not reached yet, so the port keeps its
own copy; ``Sweep``, ``Session`` and the engine follow with the engine
slice.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import policies

__all__ = ["L1Geometry", "ConfigPoint", "Axis", "SweepResult"]



# ---------------------------------------------------------------------------
# Axis value types.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class L1Geometry:
    """Static L1 data-cache shape: ``sets`` x ``ways`` lines of 32 bytes.

    These two fields size the engine's L1 state arrays, so every distinct
    geometry is a separate compiled executable — which is exactly why the
    planner treats this axis as its outer loop rather than a traced one.
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
# The labeled result grid.
# ---------------------------------------------------------------------------


_CONFIG_FIELDS = ("capacity", "policy", "alloc_no_fetch")
# Row-field name -> L1Geometry attribute, shared with repro_torch.metrics'
# axis_grid so label expansion and metric grids can never disagree.
_GEOMETRY_FIELDS = {"l1_sets": "sets", "l1_ways": "ways", "l1_kb": "kbytes"}


@dataclasses.dataclass
class SweepResult:
    """Counter grids over labeled axes.

    ``data`` maps counter name -> ndarray shaped like the axes (for the
    reference's engine sweeps: the engine counters, ``hit_rate``,
    ``event_scale`` and the per-point ``fold_exact`` certificate; for a
    table such as the roofline's: its measured fields).  ``meta`` records
    the execution history, e.g. the metrics ``derive`` evaluated.
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

    # -- the metric algebra (repro.metrics evaluates; this owns the axes) --

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
        """Evaluate a registered :mod:`repro_torch.metrics` metric over the whole
        grid and return a new result carrying it as an extra labeled
        counter (under ``out`` or the metric's name).  Relational metrics
        require ``baseline=`` (an axis-selection dict); extra keyword
        arguments are metric parameters.  Sub-metrics the evaluation pulls
        in via ``ctx.counter`` ride along in the returned data.  Deriving
        is pure counter algebra — it never compiles or dispatches."""
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
