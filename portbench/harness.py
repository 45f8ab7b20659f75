"""What every cell of the benchmark shares: finding a cell's files by
name, the card checks, cache directories inside the checkout, the
profiler's trace read into device intervals and host spans, and the
result line.

A cell is one entry of ``workloads`` in ``BENCHMARK.json``.  Its
configuration file is the one ``configs`` names; its traffic is
``traffic/<traffic>.json``; the configuration's ``kind`` names the driver
(``drivers/<kind>.py``) that sets the program up, runs the window and
decides ``correct``; each per-layer metric is read by
``metrics/<metric name>.py``.  A later cell or metric adds files and
entries, and edits none of these.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class CellError(RuntimeError):
    """A cell cannot run here (no card, too few cards, missing files)."""


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str, bench: dict | None = None) -> dict:
    """Everything one cell reads, found by the names in ``BENCHMARK.json``:
    the workload entry, its configuration (entry and file), its traffic
    file, and the end-to-end and per-layer metrics it reports."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json; "
                        f"have {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return dict(
        cell=cell, config_entry=entry,
        config=load_json(ROOT / entry["file"]),
        traffic=load_json(PKG / "traffic" / f"{cell['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])


def driver(kind: str):
    """The driver module of a configuration kind."""
    return importlib.import_module(f"portbench.drivers.{kind}")


def metric_reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def use_checkout_caches() -> None:
    """Kernel caches at fixed paths inside the checkout, so that only the
    first run of a cell in a checkout builds.  (K1's libraries already
    live in ``src/repro_torch/kernels/build/``.)"""
    cache = PKG / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def require_cards(chips: int):
    """The CUDA device count check a run makes before anything else."""
    import torch
    if not torch.cuda.is_available():
        raise CellError("torch.cuda.is_available() is false: the benchmark "
                        "runs on the card only")
    if torch.cuda.device_count() < chips:
        raise CellError(f"the cell asks for {chips} cards, "
                        f"{torch.cuda.device_count()} present")


def forbidden_loaded() -> list[str]:
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


# ------------------------------------------------------------------ trace --

def profiler():
    """A torch.profiler over CPU and CUDA activity: host spans
    (``record_function``), runtime launches and device operations."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def span(name: str, prof):
    """A host span the profiler records (``record_function``), or nothing
    when the run is not traced."""
    if prof is None:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


class Trace:
    """One traced window, read from the profiler's events.

    ``ops``: device operations (kernels, copies, sets) as (name, start_s,
    end_s), times on the host's clock from the window's start;
    ``spans``: the benchmark's host spans as (name, start_s, end_s);
    ``launched_in``: for each device operation, the innermost span open
    when the host issued it (None outside every span)."""

    def __init__(self, prof, t0_ns: int, window_s: float):
        import torch
        self.window_s = window_s
        ops, spans, launches = [], [], {}
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            start = (e.start_ns() - t0_ns) / 1e9
            end = start + e.duration_ns() / 1e9
            kind = e.activity_type() if hasattr(e, "activity_type") else ""
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if kind != "gpu_user_annotation" and not name.startswith(
                        "portbench."):           # a span's shadow: no work
                    ops.append((name, start, end, e.correlation_id(),
                                e.linked_correlation_id()))
            elif name.startswith("portbench."):
                spans.append((name, start, end))
            elif kind in ("cuda_runtime", "cuda_driver") or \
                    name.startswith("cu"):
                # cudaLaunchKernel, cudaMemcpyAsync, ...; cuBLAS launches
                # through the driver (cuLaunchKernelEx)
                launches[e.correlation_id()] = start
        ops.sort(key=lambda o: o[1])
        self.spans = sorted(spans, key=lambda sp: (sp[1], -sp[2]))
        self._segments()
        self.ops = [(n, s, e) for n, s, e, _, _ in ops]
        self.launched_in = []
        for _, s, _, cid, lid in ops:
            t = launches.get(lid, launches.get(cid))
            self.launched_in.append(None if t is None else self.span_at(t))

    def _segments(self) -> None:
        """Cut the host timeline where spans open and close, each piece
        labelled by the innermost span open over it (spans of one thread
        nest)."""
        cuts, labels, stack = [], [], []

        def close_until(t):
            while stack and stack[-1][2] <= t:
                end = stack.pop()[2]
                cuts.append(end)
                labels.append(stack[-1][0] if stack else None)

        for name, s, e in self.spans:
            close_until(s)
            cuts.append(s)
            labels.append(name)
            stack.append((name, s, e))
        close_until(float("inf"))
        self._cuts, self._labels = cuts, labels

    def span_at(self, t: float):
        """The innermost span open at host time ``t``."""
        i = bisect.bisect_right(self._cuts, t) - 1
        return self._labels[i] if i >= 0 else None

    def busy_s(self) -> float:
        """Seconds in which some device operation ran, inside the window."""
        busy, cur_s, cur_e = 0.0, None, None
        for _, s, e in self.ops:
            s, e = max(s, 0.0), min(e, self.window_s)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def device_seconds(self, match=None, span=None, outside=None) -> float:
        """Device seconds of the operations whose name ``match`` accepts
        (a compiled regex; default all), launched inside span ``span``
        or, with ``outside``, outside it."""
        total = 0.0
        for (name, s, e), where in zip(self.ops, self.launched_in):
            if match is not None and not match.search(name):
                continue
            if span is not None and where != span:
                continue
            if outside is not None and where == outside:
                continue
            total += e - s
        return total

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest
        idle gaps, each named by the host span open at its start."""
        by_name = {}
        for name, s, e in self.ops:
            key = name if len(name) <= 80 else name[:80]
            by_name[key] = by_name.get(key, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, last = {}, 0.0
        for _, s, e in self.ops + [("end", self.window_s, self.window_s)]:
            if s > last:
                key = self.span_at(last) or "outside spans"
                gaps[key] = gaps.get(key, 0.0) + (min(s, self.window_s)
                                                  - last)
            last = max(last, e)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in idle]}


# ----------------------------------------------------------------- result --

def print_checks(checks: list) -> None:
    """Each compared number beside its limit, as the last lines on
    standard error."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"({'ok' if c['ok'] else 'FAILED'})", file=sys.stderr)


def result_line(correct, attempted, failed, metrics, device, checks,
                breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return json.dumps(out)
