"""Run one cell of the port's benchmark once.

From the root of a checkout, on a machine with the cell's cards::

    python3 -m portbench.run --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` runs
the same window under the profiler and prints its per-layer metrics.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit, which the last lines of standard error repeat).  Without enough
cards, or with ``jax`` or the JAX package loaded once the window has
closed, it prints no result and exits with a code other than 0.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness
    try:
        spec = harness.cell_spec(args.workload)
        harness.use_checkout_caches()
        harness.require_cards(int(spec["cell"]["chips"]))
    except (harness.CellError, OSError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2

    import torch
    drv = harness.driver(spec["config"]["kind"])
    out = drv.run_cell(spec, args.seed, args.seconds, bool(args.trace), T0)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(spec["cell"]["chips"]),
              "memory_peak_bytes": int(out["peak_bytes"]),
              "power_limit": harness.power_limit()}
    breakdown = None
    if args.trace:
        ctx = out["ctx"]
        metrics = {}
        for m in spec["per_layer"]:
            value = harness.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        trace = out["trace"]
        device["busy_s"] = trace.busy_s()
        device["window_s"] = trace.window_s
        breakdown = trace.breakdown()
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in spec["end_to_end"]}

    bad = harness.forbidden_loaded()
    if bad:
        print(f"portbench: the run loaded {bad}, which the port may not "
              "use", file=sys.stderr)
        return 3
    checks = out["checks"]
    correct = all(c["ok"] for c in checks)
    harness.print_checks(checks)
    print(harness.result_line(correct, out["attempted"], out["failed"],
                              metrics, device, checks, breakdown),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
