"""Network-level lowering: a registry model into registered kernels
(the port of the reference's ``bridge/network.py``).

``lower_network(model)`` walks the model's LayerOps (:mod:`.shapes`),
deduplicates them by shape signature, registers one benchmark per unique
signature through the ordinary ``@register_benchmark`` registry (domain
``"network"``, idempotent via ``exist_ok``), and returns a
:class:`LoweredNetwork` mapping every layer instance onto its kernel with
a count and macro factor.  Because the registered kernels are plain
benchmarks, a whole model becomes one ``Sweep(kernels=net.kernels, ...)``
— or, via the ``network`` axis on :class:`repro_torch.api.Sweep`, just
``Sweep(network=("granite-8b", ...))``.

``network_report`` folds per-kernel sweep results back into per-model
totals: each unit's counters scale by ``count * macro_factor`` (tile
programs cover a fixed sub-problem; the macro factor is real-work /
tile-work, see :mod:`.lower`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.bridge import lower, shapes
from repro_torch.rvv import common as rvv_common


@dataclasses.dataclass(frozen=True)
class NetworkUnit:
    """One deduplicated layer group of a lowered network."""

    kernel: str           # registered benchmark name (net:<kind>:<shape>)
    kind: str             # gemm | attn | scan
    labels: tuple         # layer labels merged into this unit
    shape: tuple          # real layer shape (signature dims)
    count: int            # instances across the network
    macro_factor: float   # real work / tile work, per instance
    params: dict          # tile build kwargs

    @property
    def scale(self) -> float:
        """Counter multiplier taking one tile run to network-level work."""
        return self.count * self.macro_factor


@dataclasses.dataclass(frozen=True)
class LoweredNetwork:
    model: str
    units: tuple

    @property
    def kernels(self) -> tuple:
        """Sorted unique kernel names (the Sweep kernel axis)."""
        return tuple(sorted({u.kernel for u in self.units}))

    @property
    def num_instances(self) -> int:
        return sum(u.count for u in self.units)

    def summary(self) -> dict:
        """JSON-friendly description (lands in ``Session.run`` meta)."""
        return dict(model=self.model, kernels=list(self.kernels),
                    units=len(self.units), instances=self.num_instances)


def _register(name: str, kind: str, kwargs: dict, op) -> None:
    rvv_common.register_benchmark(
        name, domain="network", paper_params=dict(kwargs),
        reduced_params=dict(kwargs),
        table2=f"bridge-lowered {kind} {'x'.join(map(str, op.shape))}",
        scalar_cost=lower.cost_for(kind), exist_ok=True,
    )(lower.builder_for(kind))


def lower_network(model: str) -> LoweredNetwork:
    """Lower registry model ``model``; idempotent (re-lowering a model, or
    lowering two models sharing a layer shape, reuses registered kernels).
    """
    groups: dict[tuple, list] = {}
    for op in shapes.model_ops(model):
        groups.setdefault(op.signature, []).append(op)
    units = []
    for sig, ops in sorted(groups.items(), key=lambda kv: repr(kv[0])):
        name, kwargs, macro = lower.tile_for(ops[0])
        _register(name, ops[0].kind, kwargs, ops[0])
        units.append(NetworkUnit(
            kernel=name, kind=ops[0].kind,
            labels=tuple(o.label for o in ops), shape=tuple(sig[1:]),
            count=sum(o.count for o in ops), macro_factor=macro,
            params=dict(kwargs)))
    return LoweredNetwork(model=model, units=tuple(units))


def network_report(result, lowered, metrics=("scaled_cycles",),
                   capacity_bytes_per_reg: int = 32) -> list[dict]:
    """Per-model totals from a per-kernel sweep result.

    ``result``: a ``SweepResult`` whose first axis is ``kernel`` and whose
    data contains every name in ``metrics`` (``derive`` them first).
    ``lowered``: a LoweredNetwork or list thereof; every unit's kernel
    must be on the result's kernel axis.  One row per (model, non-kernel
    grid point): the point's axis labels, the model's cVRF footprint
    (capacity x 32 B vector registers), and ``<metric>_total`` — the
    count x macro-factor weighted sum of the metric over the model's
    units (tile counters scaled back to network-level work).  The sum
    runs in Python floats in the units' order, as the reference's does,
    so the totals are bit-equal to its (a vectorised reduction would
    reorder it).
    """

    if isinstance(lowered, LoweredNetwork):
        lowered = [lowered]
    kaxis = result.axis("kernel")
    if result.axes[0].name != "kernel":
        raise ValueError("network_report expects kernel as the first axis")
    ki_for = {n: i for i, n in enumerate(kaxis.values)}
    rows = []
    other = result.axes[1:]
    for idx in np.ndindex(*(len(a) for a in other)):
        labels = result._labels((0,) + idx)
        labels.pop("kernel", None)
        for net in lowered:
            row = dict(model=net.model, **labels)
            row["kernels"] = len(net.kernels)
            row["instances"] = net.num_instances
            if "capacity" in row:
                row["footprint_bytes"] = (int(row["capacity"])
                                          * capacity_bytes_per_reg)
            for m in metrics:
                vals = result.data[m]
                total = 0.0
                for u in net.units:
                    total += float(vals[(ki_for[u.kernel],) + idx]) * u.scale
                row[f"{m}_total"] = total
            rows.append(row)
    return rows
