"""K1's device time on the engine's three timing inputs, for one tree.

    python src/repro_torch/benchmarks/engine_timing.py [--src DIR]
        [--label NAME] [--json OUT] [--profile]

Builds the eleven ``rvv`` programs at their paper size and times
``kernels.engine_scan.engine_scan_cuda`` on the card over the inputs
``chip_smoke.py``'s ``[engine]`` phase times: the folded table3 grid
(capacity 32, FIFO, 16 KB/2-way L1), unfolded resnet50_l10 (one lane) and
the folded 4 KB pareto grid (capacities 3-32, 4 KB/2-way).  Each time is
the mean of 3 calls after a warm-up, by CUDA events.  The counters of the
first call are printed too, so two trees' results can be compared.
``--profile`` adds each input's device time per CUDA kernel over one
call, from ``torch.profiler`` (empty where it records no device time).

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that two trees, for example a commit and
its parent unpacked with ``git archive``, are timed on one card in one
session, in turns.  The script uses only what every version of the
port's engine has: ``rvv``, ``simulator.prepare``, ``simulator._stack``,
``engine_scan.pack`` and ``engine_scan_cuda``.  It prints one JSON line
per input, then the card's name and power limit; ``--json`` also writes
the lines to a file.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

PARETO_CAPS = (3, 4, 5, 6, 8, 10, 12, 16, 32)
ITERS = 3


def _time_ms(fn) -> float:
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


# The engine's CUDA kernels, by the name the profiler records
KERNEL_NAMES = re.compile(
    r"(engine_scan|engine_reg|l1_trace_sums|l1_bucket|scan_sums|scan_blocks"
    r"|scan_apply|l1_walk|l1_reduce|l1_finish)(<[^>]*>)?")


def _per_kernel_ms(fn, names=KERNEL_NAMES) -> dict:
    """Device ms per CUDA kernel (and memset) over one call of ``fn``,
    each kernel named by its match of ``names``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        m = names.search(e.key)
        name = m.group(0) if m else e.key[:40]
        if us:
            out[name] = out.get(name, 0.0) + us / 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--json", default=None)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch

    from repro_torch import rvv
    from repro_torch.core import isa, simulator
    from repro_torch.kernels import engine_scan as es

    if not torch.cuda.is_available():
        print("engine_timing: no CUDA device", file=sys.stderr)
        return 1
    programs = {n: b.build(**b.paper_params).program
                for n, b in rvv.BENCHMARKS.items()}
    m16 = simulator.DEFAULT_MACHINE
    m4 = simulator.MachineParams(l1_sets=64, l1_ways=2)
    inputs = (
        ("table3_folded", list(programs), True, [isa.NUM_ARCH_VREGS], m16),
        ("resnet50_l10_unfolded", ["resnet50_l10"], False,
         [isa.NUM_ARCH_VREGS], m16),
        ("pareto_4kb_folded", list(programs), True, list(PARETO_CAPS), m4))
    lines = []
    for label, names, fold, caps, machine in inputs:
        t0 = time.perf_counter()
        preps = [simulator.prepare(programs[n], fold=fold, machine=machine)
                 for n in names]
        prepare_s = time.perf_counter() - t0
        arrays, spill0s = simulator._stack(preps)
        x = es.pack(arrays).cuda()
        sweep = simulator.SweepConfig.make(caps)
        cfg = (sweep.capacity, sweep.policy, sweep.alloc_no_fetch)
        mach = (np.int32([machine.l1_hit_cycles]),
                np.int32([machine.uop_hit_cycles]),
                np.int32([machine.mem_latency]))
        kw = dict(l1_sets=machine.l1_sets, l1_ways=machine.l1_ways,
                  track_ab=fold, lengths=[p.num_rows for p in preps])
        ctr = es.engine_scan_cuda(x, spill0s, cfg, mach, **kw)[0].cpu()
        ms = _time_ms(lambda: es.engine_scan_cuda(x, spill0s, cfg, mach,
                                                  **kw))
        line = dict(tree=args.label, input=label, ms=ms,
                    rows=sum(kw["lengths"]), longest=max(kw["lengths"]),
                    lanes=len(preps) * len(caps), prepare_s=prepare_s,
                    cycles=ctr[..., 0, 0].reshape(-1).tolist())
        if args.profile:
            line["kernel_ms"] = _per_kernel_ms(
                lambda: es.engine_scan_cuda(x, spill0s, cfg, mach, **kw))
        print(json.dumps(line), flush=True)
        lines.append(line)
        del x
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    if args.json:
        with open(args.json, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
