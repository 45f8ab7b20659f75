"""Benchmark harness of the port: the paper's tables and figures through
:class:`repro_torch.api.Session` (K1 on the card), plus the measured
roofline and the working-set study.  Prints one CSV block per suite.

  python -m repro_torch.benchmarks.run                  # every suite, card
  python -m repro_torch.benchmarks.run table3 fig4      # subset
  python -m repro_torch.benchmarks.run --json OUT.json fig4 table3
  python -m repro_torch.benchmarks.run --device cpu --kernels dropout \\
      --max-events 2000 fig4

``--device`` is where the engine and the kernels run: ``cuda`` (the
default; without a card the run raises) or ``cpu`` (K1's plain twin and
the kernels' plain versions: reduced budgets only).  ``--kernels a,b``
restricts every suite whose ``main()`` takes a kernel list
(table3/fig4/fig5/fig6/fig8/pareto/cluster_sweep/dse) to that subset;
fixed-roster studies (fig2, policy_headroom, ablation_sensitivity, ...)
run their own set and say so.  ``--max-events N`` forwards the legacy truncation budget the same
way.

``--json PATH`` writes the reference's report layout (``schema: 7``):
per-suite wall-clock, the sweep-axis metadata of every ``Session.run``
the suite made including the metrics it derived, the full metric
registry catalog (``metrics``), the silicon macro catalog
(``macro_models``) and per-kernel cycle counts (``kernels``, keyed as
the reference keys them).  Where the port's record differs: a suite has
no ``compiles`` (an XLA notion); ``dispatches`` counts the Session's
engine calls, ``launches`` the K1a (``engine_reg``), K1b
(``engine_l1``) and K2 (``cluster_l2``) launches they made (the roofline adds its kernels'
launches from ``perf_stats()``), ``prepare_s``/``engine_s`` the host
seconds spent preparing traces and in engine calls, and ``device`` names
where it ran.  The roofline's ``json_extra()`` is its record's ``extra``.

The serving suites (``kv_dispersion``, ``serving_slo``) run the pool and
the serving engine on ``--device``; their records count no engine calls.
``network_sweep`` lowers five registry models through the bridge
(:mod:`repro_torch.bridge`) into ``net:*`` tile programs and runs them
as one sweep, K1 on the card.  Every suite of the reference's
``benchmarks/run.py`` has its port here.
"""

from __future__ import annotations

import inspect
import json
import sys
import time

from repro_torch import api, metrics, silicon

SCHEMA_VERSION = 7

_MODULES = {
    "table3": "repro_torch.benchmarks.table3_speedup",
    "fig4": "repro_torch.benchmarks.fig4_cvrf_sweep",
    "fig5": "repro_torch.benchmarks.fig5_min_regs",
    "fig6": "repro_torch.benchmarks.fig6_equal_area",
    "fig2": "repro_torch.benchmarks.fig2_area_model",
    "fig8": "repro_torch.benchmarks.fig8_power",
    "pareto": "repro_torch.benchmarks.pareto_frontier",
    "policy_headroom": "repro_torch.benchmarks.policy_headroom",
    "vmem_dispersion": "repro_torch.benchmarks.vmem_dispersion",
    "ablation_sensitivity": "repro_torch.benchmarks.ablation_sensitivity",
    "roofline": "repro_torch.benchmarks.roofline",
    "cluster_sweep": "repro_torch.benchmarks.cluster_sweep",
    "dse": "repro_torch.benchmarks.dse",
    "kv_dispersion": "repro_torch.benchmarks.kv_dispersion",
    "serving_slo": "repro_torch.benchmarks.serving_slo",
    "network_sweep": "repro_torch.benchmarks.network_sweep",
}

SUITES = tuple(_MODULES)

_CYCLE_KEYS = ("vec_cycles", "scalar_cycles", "fifo_cycles",
               "fifo_no_fetch_cycles", "cycles")


def _sweep_meta(history_slice: list[dict]) -> list[dict]:
    """Axis + derived-metric metadata for the suite's ``Session.run``
    calls (JSON-safe)."""
    return [dict(axes=h["axes"], points=h["points"],
                 dispatches=h["dispatches"], launches=h["launches"],
                 fold=h["fold"], kernel_params=h["kernel_params"],
                 derived=list(h.get("derived", ())))
            for h in history_slice]


def _call_main(mod, kernels, max_events, session):
    """Invoke a suite's main(), forwarding only the kwargs it accepts: the
    Session to the paper suites, its device to the kernel suites."""
    params = inspect.signature(mod.main).parameters
    kw = {}
    if kernels:
        if "names" in params:
            kw["names"] = list(kernels)
        else:
            print("(fixed-roster suite: --kernels ignored)", flush=True)
    if max_events and "max_events" in params:
        kw["max_events"] = max_events
    if "session" in params:
        kw["session"] = session
    if "device" in params:
        kw["device"] = str(session.device)
    return mod.main(**kw) or []


def _pop_flag(args: list, flag: str):
    if flag not in args:
        return None
    i = args.index(flag)
    if i + 1 >= len(args):
        raise SystemExit(f"error: {flag} requires a value")
    value = args[i + 1]
    del args[i:i + 2]
    return value


def _kernel_records(report: dict, suite: str, rows: list[dict]) -> None:
    for r in rows:
        cyc = {k: r[k] for k in _CYCLE_KEYS if k in r}
        if cyc and isinstance(r.get("name"), str):
            kern = report["kernels"].setdefault(r["name"], {})
            # Every grid field the row carries keys the record, so e.g.
            # pareto rows at the same capacity but different L1
            # geometries never overwrite each other.
            suffix = "".join(
                f"_{tag}{r[f]}" for tag, f in
                (("cap", "capacity"), ("l1", "l1_kb")) if f in r)
            for k, v in cyc.items():
                kern[f"{suite}{suffix}.{k}"] = v


def main(argv=None, session: api.Session | None = None) -> int:
    """Run the named suites (all by default) and print their CSV blocks;
    with ``--json`` write the report.  ``session`` runs the paper suites
    (default: a new Session on ``--device`` if given, else the
    process-default Session).  Returns the exit code: 2 for a bad flag or
    an unknown suite."""
    args = list(argv if argv is not None else sys.argv[1:])
    try:
        json_path = _pop_flag(args, "--json")
        kernels = _pop_flag(args, "--kernels")
        max_events = _pop_flag(args, "--max-events")
        device = _pop_flag(args, "--device")
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    kernels = [k for k in kernels.split(",") if k] if kernels else None
    if max_events is not None:
        try:
            max_events = int(max_events)
            if max_events <= 0:
                raise ValueError
        except ValueError:
            print(f"error: --max-events needs a positive integer, got "
                  f"{max_events!r}", file=sys.stderr)
            return 2
    suites = args or list(SUITES)
    unknown = [s for s in suites if s not in _MODULES]
    if unknown:
        print(f"error: unknown suite(s) {', '.join(unknown)}; "
              f"choose from: {', '.join(SUITES)}", file=sys.stderr)
        return 2
    if session is None:
        session = (api.Session(device=device) if device is not None
                   else api.default_session())
    report = {"schema": SCHEMA_VERSION, "device": str(session.device),
              "suites": {}, "kernels": {}, "metrics": metrics.catalog(),
              "macro_models": silicon.macro_catalog()}
    d00, t00 = session.dispatch_count(), time.time()
    for suite in suites:
        mod = __import__(_MODULES[suite], fromlist=["main"])
        print(f"\n## {suite} ({_MODULES[suite]})", flush=True)
        t0 = time.time()
        d0, l0 = session.dispatch_count(), session.launch_count()
        p0, e0 = session.prepare_seconds(), session.engine_seconds()
        h0 = len(session.history)
        rows = _call_main(mod, kernels, max_events, session)
        dt = time.time() - t0
        print(f"## {suite} done in {dt:.1f}s", flush=True)
        record = {
            "wall_s": round(dt, 2),
            "rows": len(rows),
            "dispatches": session.dispatch_count() - d0,
            "launches": {k: n - l0[k]
                         for k, n in session.launch_count().items()},
            "prepare_s": round(session.prepare_seconds() - p0, 3),
            "engine_s": round(session.engine_seconds() - e0, 3),
            "device": str(session.device),
            "sweeps": _sweep_meta(session.history[h0:]),
        }
        # The roofline drives its kernels directly and counts their
        # launches itself; the Session never sees those calls.
        if hasattr(mod, "perf_stats"):
            ps = mod.perf_stats()
            record["launches"].update(ps.get("kernel_launches", {}))
            for key in ("plain_calls", "route_launches"):
                if key in ps:
                    record[key] = ps[key]
        if hasattr(mod, "json_extra"):
            record["extra"] = mod.json_extra()
        report["suites"][suite] = record
        _kernel_records(report, suite, rows)
    total = time.time() - t00
    print(f"\nALL BENCHMARKS DONE in {total:.1f}s")
    if json_path:
        report["total_wall_s"] = round(total, 2)
        report["total_dispatches"] = session.dispatch_count() - d00
        with open(json_path, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        print(f"wrote {json_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
