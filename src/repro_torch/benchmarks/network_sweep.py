"""Whole-network sweeps: registry models through the trace-from-model bridge.

The paper demonstrates register dispersion on hand-written kernels plus one
densenet layer; this suite generalises that to whole networks.  Each model
named in ``MODELS`` is lowered by :mod:`repro_torch.bridge` — every layer's
concrete shapes become way-span-padded ``Assembler.repeat`` tile programs,
deduplicated by shape signature — and the union runs as ONE declarative
``Session.run`` over capacity x L1 geometry: one engine call per L1
geometry (K1 on the card).  Folding keeps it tractable (each layer is a
certified period).  The port of the reference's
``benchmarks/network_sweep.py``; where it differs: the plan has no shape
buckets, and the record counts engine calls and kernel launches
(``dispatches``, ``launches``) instead of XLA compiles.

Reported per (model, capacity, L1): the cVRF footprint, and network-level
cycle/energy totals — per-kernel tile counters scaled by each layer's
count x macro-factor (real work / tile work, ``docs/bridge.md``).
"""

from __future__ import annotations

from repro_torch import api, bridge
from repro_torch.benchmarks import common

MODELS = ("granite-8b", "qwen3-8b", "falcon-mamba-7b",
          "recurrentgemma-2b", "deepseek-v2-lite-16b")
CAPS = (3, 4, 8, 12, 32)
L1_KBYTES = (4, 16)

_LAST_EXTRA: dict = {}


def run(models=MODELS, caps=CAPS, l1_kbytes=L1_KBYTES, max_events=None,
        fold=True, session=None) -> list[dict]:
    ses = session or api.default_session()
    sweep = api.Sweep(
        network=tuple(models), capacity=tuple(caps),
        l1_geometry=tuple(api.L1Geometry.from_kbytes(kb)
                          for kb in l1_kbytes),
        fold=fold, max_events=max_events)
    res, dt = common.timed(ses.run, sweep)
    res = res.derive("scaled_cycles").derive("energy")
    lowered = list(getattr(sweep, "_lowered"))
    us_each = dt * 1e6 / max(1, len(sweep.kernels))
    rows = []
    for r in bridge.network_report(res, lowered,
                                   metrics=("scaled_cycles", "energy")):
        rows.append(dict(
            name=r["model"], us_per_call=round(us_each, 1),
            capacity=r["capacity"], l1_kb=r["l1_kb"],
            footprint_bytes=r["footprint_bytes"], kernels=r["kernels"],
            instances=r["instances"],
            cycles_total=r["scaled_cycles_total"],
            energy_total=r["energy_total"],
        ))
    fe = res.data["fold_exact"]
    _LAST_EXTRA.clear()
    _LAST_EXTRA.update(
        networks=res.meta.get("networks", []),
        points=res.meta["points"], dispatches=res.meta["dispatches"],
        launches=res.meta["launches"],
        fold_exact_fraction=float(fe.mean()),
        rows=rows,
    )
    return rows


def main(max_events: int | None = None, session=None) -> list[dict]:
    rows = run(max_events=max_events, session=session)
    common.emit(rows, ["name", "us_per_call", "capacity", "l1_kb",
                       "footprint_bytes", "kernels", "instances",
                       "cycles_total", "energy_total"])
    return rows


def json_extra() -> dict:
    """Per-model network payload for ``run.py --json``: the
    lowered-network summaries, engine-call and launch accounting and the
    per-point report rows."""
    return dict(_LAST_EXTRA)


if __name__ == "__main__":
    main()
