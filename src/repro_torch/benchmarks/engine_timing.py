"""K1's and K2's device time on the engine's timing inputs, for one tree.

    python src/repro_torch/benchmarks/engine_timing.py [--src DIR]
        [--label NAME] [--json OUT] [--profile]
        [--inputs engine|cluster|all]

Builds the eleven ``rvv`` programs at their paper size and times
``kernels.engine_scan.engine_scan_cuda`` on the card over the inputs
``chip_smoke.py``'s ``[engine]`` phase times: the folded table3 grid
(capacity 32, FIFO, 16 KB/2-way L1), unfolded resnet50_l10 (one lane) and
the folded 4 KB pareto grid (capacities 3-32, 4 KB/2-way).  Each time is
the mean of 3 calls after a warm-up, by CUDA events.  The counters of the
first call are printed too, so two trees' results can be compared.
``--profile`` adds each input's device time per CUDA kernel over one
call, from ``torch.profiler`` (empty where it records no device time).

The cluster inputs (``--inputs cluster``) are the cluster suites' main
grids at paper size: cluster_sweep's folded 4 KB grid (capacities 3, 4,
8 x 1, 2, 4, 8 cores) and dse's folded 8 KB grid (capacities 3, 4, 8, 32
x 1, 2, 4 cores), each over gemv, dropout and flashattention2 behind the
suites' 256 x 4 L2.  Each times ``cluster_scan_cuda`` (K1 then K2, the
mean of 3 calls after a warm-up); with ``--profile`` it splits one call's
device time into K1's kernels (``K1_NAMES``) and the rest, K2's, and
times K2 alone (``cluster_l2_cuda`` on K1b's kept buffers, per launch
group): its CUDA-event ms, its device ms per kernel and memset, the host
gap between them, the host's time to issue a call (again, and as a
plan's first), its bucketed requests
and largest (lane, L2 set) bucket.

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that two trees, for example a commit and
its parent unpacked with ``git archive``, are timed on one card in one
session, in turns.  The script uses only what every version of the
port's engine has: ``rvv``, ``simulator.prepare``, ``simulator._stack``,
``engine_scan.pack`` and ``engine_scan_cuda``; the cluster inputs also
``api.Session.prepared``, the two suites' constants, ``cluster_scan_cuda``
and, for K2 alone, ``cluster_scan_plan``, ``address_invariant``,
``engine_reg_cuda``, ``engine_l1_cuda(..., keep=True)`` and
``cluster_l2_cuda(..., stats=...)``.  It prints one JSON line
per input, then the card's name and power limit; ``--json`` also writes
the lines to a file.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
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


# K1's kernels alone: K2 runs the same exclusive scan under tag 1
K1_NAMES = re.compile(
    r"(engine_scan|engine_reg|l1_trace_sums|l1_bucket|scan_sums<0>"
    r"|scan_blocks<0>|scan_apply<0>|l1_walk|l1_reduce|l1_finish)"
    r"(<[^>]*>)?")
# Any CUDA kernel, by its function name and template arguments
ANY_KERNEL = re.compile(r"[A-Za-z_]\w*(<[^()]*>)?(?=\()")
CLUSTER_INPUTS = (("cluster_sweep_4kb_folded", "cluster_sweep", 4),
                  ("dse_8kb_folded", "dse", 8))


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


def _l1_machine(simulator, kbytes: int):
    """An L1 of ``kbytes`` KB, 2 ways of 32-byte lines."""
    return simulator.MachineParams(l1_sets=kbytes * 1024 // 32 // 2,
                                   l1_ways=2)


def _k2_alone(cs, es, x, spill0s, strides, cfg, mach, clusters, kw) -> dict:
    """K2 alone per launch group: K1a and K1b once (K1b's buffers kept),
    then ``cluster_l2_cuda``'s CUDA-event ms, the host's time to issue one
    call (no synchronisation inside the window), again on the same plan
    and as a plan's first (which copies the lanes' arrays; every call, on
    a tree that keeps no copy), one call's device ms per kernel and
    memset, the host gap (event ms less device ms), K1b's
    records, the K2 lanes and per-core outputs, and the figures the
    wrapper's ``stats`` gives (summed over the groups; the largest bucket
    the largest)."""
    import numpy as np
    import torch

    lengths = kw["lengths"]
    plan = cs.cluster_scan_plan(
        kw["l1_sets"], kw["l1_ways"], lengths, cfg, clusters,
        strides=strides, invariant=cs.address_invariant(
            x, spill0s, strides, lengths, max(c.n_cores for c in clusters)),
        T=x.shape[1])
    out = dict(groups=len(plan["groups"]), ms=0.0, device_ms=0.0,
               host_issue_ms=0.0, host_issue_first_ms=0.0, per_kernel_ms={},
               records=0, k2_lanes=0, per_core_outputs=0)
    for g in plan["groups"]:
        stream = torch.empty((0, x.shape[1], es.REG_SITES),
                             dtype=torch.int8, device=x.device)
        ctr = torch.zeros((0, es.NUM_SETS, len(es.REG_COUNTERS)),
                          dtype=torch.int32, device=x.device)
        if g["reg_lanes"]:
            prog, k = map(list, zip(*g["reg_lanes"]))
            stream, ctr = es.engine_reg_cuda(
                x, prog, tuple(np.asarray(a)[k] for a in cfg),
                track_ab=kw["track_ab"], lengths=lengths)
        l1_prog, _, l1_reg, l1_base = map(list, zip(*g["l1_lanes"]))
        k1_outs, keep = es.engine_l1_cuda(
            x, spill0s, stream, ctr, l1_prog, l1_reg,
            [j for _, _, j in g["k1_outputs"]], mach, l1_sets=kw["l1_sets"],
            l1_ways=kw["l1_ways"], track_ab=kw["track_ab"], lengths=lengths,
            l1_base=l1_base, keep=True)

        def call(stats=None):
            return cs.cluster_l2_cuda(
                x, keep, g, k1_outs, mach, clusters, l1_sets=kw["l1_sets"],
                track_ab=kw["track_ab"], lengths=lengths, stats=stats)
        stats = {}
        call(stats)
        for key, v in stats.items():
            out[key] = (max(out.get(key, 0), v) if key == "largest_bucket"
                        else out.get(key, 0) + v)
        out["records"] += int(keep["hist"][-1])
        out["k2_lanes"] += len(g["k2_lanes"])
        out["per_core_outputs"] += sum(len(o[4]) for o in g["k2_outputs"])
        out["ms"] += _time_ms(call)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            call()
        out["host_issue_ms"] += (time.perf_counter() - t0) * 1e3 / ITERS
        torch.cuda.synchronize()
        t_first = 0.0
        for _ in range(ITERS):
            g.get("k2_table", {}).pop("on", None)
            t0 = time.perf_counter()
            call()
            t_first += time.perf_counter() - t0
        out["host_issue_first_ms"] += t_first * 1e3 / ITERS
        torch.cuda.synchronize()
        for name, ms in _per_kernel_ms(call, ANY_KERNEL).items():
            out["per_kernel_ms"][name] = out["per_kernel_ms"].get(
                name, 0.0) + ms
            out["device_ms"] += ms
        del keep
    out["host_gap_ms"] = out["ms"] - out["device_ms"]
    return out


def _cluster_lines(args) -> list:
    """The cluster inputs' lines: cluster_scan_cuda's ms and counters,
    with ``--profile`` its K1/K2 split and K2 alone."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.cluster import engine as cluster_engine
    from repro_torch.core import simulator
    from repro_torch.kernels import cluster_scan as cs
    from repro_torch.kernels import engine_scan as es

    session = api.Session(device="cuda")
    lines = []
    for label, suite, kb in CLUSTER_INPUTS:
        mod = importlib.import_module(f"repro_torch.benchmarks.{suite}")
        machine = _l1_machine(simulator, kb)
        t0 = time.perf_counter()
        preps = [session.prepared(n, fold=True, machine=machine)
                 for n in mod.KERNELS]
        prepare_s = time.perf_counter() - t0
        arrays, spill0s = simulator._stack(preps)
        x = es.pack(arrays).cuda()
        strides = [cluster_engine._stride(p) for p in preps]
        sweep = simulator.SweepConfig.make(mod.CAPS)
        cfg = (sweep.capacity, sweep.policy, sweep.alloc_no_fetch)
        mach = (np.int32([machine.l1_hit_cycles]),
                np.int32([machine.uop_hit_cycles]),
                np.int32([machine.mem_latency]))
        clusters = [dataclasses.replace(mod.CLUSTER, n_cores=n)
                    for n in mod.CORES]
        kw = dict(l1_sets=machine.l1_sets, l1_ways=machine.l1_ways,
                  track_ab=any(p.num_folds for p in preps),
                  lengths=[p.num_rows for p in preps])

        def run():
            return cs.cluster_scan_cuda(x, spill0s, strides, cfg, mach,
                                        clusters, **kw)
        got = run()
        line = dict(tree=args.label, input=label, ms=_time_ms(run),
                    rows=sum(kw["lengths"]), longest=max(kw["lengths"]),
                    programs=len(preps), configs=len(mod.CAPS),
                    cores=list(mod.CORES), prepare_s=prepare_s,
                    cycles=[o[0][..., 0].reshape(-1).tolist() for o in got],
                    l2_misses=[o[0][..., 14].reshape(-1).tolist()
                               for o in got])
        if args.profile:
            kernels = _per_kernel_ms(run, ANY_KERNEL)
            line["kernel_ms"] = kernels
            line["k1_device_ms"] = sum(ms for name, ms in kernels.items()
                                       if K1_NAMES.search(name))
            line["k2_device_ms"] = sum(ms for name, ms in kernels.items()
                                       if not K1_NAMES.search(name))
            line["k2_alone"] = _k2_alone(cs, es, x, spill0s, strides, cfg,
                                         mach, clusters, kw)
        print(json.dumps(line), flush=True)
        lines.append(line)
        del x, got
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--json", default=None)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--inputs", choices=("engine", "cluster", "all"),
                    default="all")
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
    lines = []
    if args.inputs != "engine":
        lines += _cluster_lines(args)
    programs = {n: b.build(**b.paper_params).program
                for n, b in rvv.BENCHMARKS.items()} if (
        args.inputs != "cluster") else {}
    m16 = simulator.DEFAULT_MACHINE
    m4 = simulator.MachineParams(l1_sets=64, l1_ways=2)
    inputs = (
        ("table3_folded", list(programs), True, [isa.NUM_ARCH_VREGS], m16),
        ("resnet50_l10_unfolded", ["resnet50_l10"], False,
         [isa.NUM_ARCH_VREGS], m16),
        ("pareto_4kb_folded", list(programs), True, list(PARETO_CAPS), m4)
    ) if programs else ()
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
