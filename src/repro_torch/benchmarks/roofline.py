"""Measured roofline over the port's kernels.

Port of ``benchmarks/roofline.py``'s measured suite.  It times the three
dispersed-accumulator schedules — ``matmul_grouped`` (K3, working set
W >= 1), ``matmul_dispersed`` (K4, the W=0 spill/fill extreme) and
``flash_attention`` (K5) — and holds every point's schedule byte count
(:mod:`repro_torch.kernels.traffic`, walking the reference's grid and
index maps) against the closed-form ``hbm_traffic_model``: a per-row
``model_agree`` flag.  Both byte columns are the *schedule's* counts, not
bytes measured on the card (whose L2 may serve repeated blocks).

The accumulator working set W and the input precision (f32 / bf16 /
int8) are labeled axes: rows go through
:meth:`repro_torch.api.SweepResult.from_table`, so the suite derives
``arithmetic_intensity`` / ``model_arithmetic_intensity`` /
``achieved_gflops`` from the metric registry, normalizes time against
the W=0 extreme, and reports the footprint-vs-time Pareto front per
shape.  An equal-footprint study asks, at a fixed accumulator budget,
which (W, block_m, block_k) point wins.

Differences from the reference: ``device`` picks where the kernels run
(``"cuda"`` by default; ``"cpu"`` runs the plain twins); time is the
median of CUDA-event timings of back-to-back calls on the card and of
``time.perf_counter`` on the CPU; ``json_extra()`` records ``device``
where the reference records ``interpret``; ``perf_stats()`` reports
kernel launches and plain-twin calls counted in the wrappers, and the
GEMM and attention launches of each precision by route
(``route_launches``: tensor cores or CUDA-core FMAs, see
``dispersed_gemm`` and ``flash_attention``).  The
reference's legacy dry-run table needs the launch layer and is not
ported yet.

    python -m repro_torch.benchmarks.roofline [--device cpu] [--smoke]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import api
from repro_torch.benchmarks import common
from repro_torch.device import resolve_device
from repro_torch.kernels import dispersed_gemm, flash_attention, traffic
from repro_torch.kernels.ref import cast_like

# (m, k, n) GEMM cases and (b, h, s, d) attention cases, as in the
# reference.
GEMM_CASES = {"gemm_256x512x256": (256, 512, 256),
              "gemm_512x512x256": (512, 512, 256)}
FLASH_CASES = {"attn_b1h2_s256_d64": (1, 2, 256, 64)}
W_AXIS = (0, 1, 2, 4)                  # 0 = the dispersed (spill/fill) extreme
PRECISIONS = ("f32", "bf16", "int8")
BLOCK_M, BLOCK_K = 64, 128
FLASH_BLOCK = 64

SMOKE_GEMM_CASES = {"gemm_128x256x128": (128, 256, 128)}
SMOKE_FLASH_CASES = {"attn_b1h1_s128_d64": (1, 1, 128, 64)}
SMOKE_W_AXIS = (0, 1, 2)

# Calls per timed sample on the card (see _measure).
BACK_TO_BACK = 10

# Counted-vs-model agreement: both sides are exact byte counts, so the
# tolerance only absorbs float round-off in the ratio.
AGREE_RTOL = 0.01

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
_BYTES = {"f32": 4, "bf16": 2, "int8": 1}
# Wrapper counters read by perf_stats(): kernel -> (CUDA fn, plain twin).
_COUNTED = {
    "matmul_grouped": (dispersed_gemm.matmul_grouped_cuda,
                       dispersed_gemm.matmul_grouped_plain),
    "matmul_dispersed": (dispersed_gemm.matmul_dispersed_cuda,
                         dispersed_gemm.matmul_dispersed_plain),
    "flash_attention": (flash_attention.flash_attention_cuda,
                        flash_attention.flash_attention_plain),
}

_LAST_EXTRA: dict = {}
_STATS: dict = {}
# "gemm" / "flash_attention" -> precision -> {"tc": launches, "fma": ...}
_ROUTES: dict = {}


def _counts() -> dict:
    return {name: (cuda.launches, plain.calls)
            for name, (cuda, plain) in _COUNTED.items()}


def _randn(shape, seed: int, prec: str, device) -> torch.Tensor:
    """Standard-normal f32 from a seeded generator, cast to the precision
    as the reference casts (int8 truncated and saturated)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen, dtype=torch.float32)
    return cast_like(x, _DTYPES[prec]).to(device)


def _measure(fn, device: torch.device, repeats: int,
             calls: int = BACK_TO_BACK) -> float:
    """Median us per call over ``repeats`` samples, after one warm-up call
    (which also builds the kernel).  On the card a sample is CUDA events
    around ``calls`` back-to-back calls: the host's work for one call
    overlaps the device's work on the one before, so the time is the
    device's unless the host is the slower of the two.  On the CPU a
    sample is ``time.perf_counter`` around one call."""
    fn()
    times = []
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3 / calls)
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
    times.sort()
    return times[len(times) // 2]


def _gemm_point(case, m, k, n, w, prec, *, block_m, block_k, device,
                repeats) -> dict:
    bpe = _BYTES[prec]
    a = _randn((m, k), 0, prec, device)
    b = _randn((k, n), 1, prec, device)
    model = dispersed_gemm.hbm_traffic_model(
        m, n, k, block_m=block_m, block_k=block_k,
        working_set=max(w, 1), bytes_per_el=bpe)
    if w == 0:
        fn = lambda: dispersed_gemm.matmul_dispersed(
            a, b, block_m=block_m, block_k=block_k)
        schedule = dispersed_gemm.dispersed_schedule(
            m, n, k, block_m=block_m, block_k=block_k, bytes_per_el=bpe)
        model_bytes, vmem_acc = model["dispersed"], 0
        name = f"{case}_dispersed_{prec}"
    else:
        fn = lambda: dispersed_gemm.matmul_grouped(
            a, b, block_m=block_m, block_k=block_k, working_set=w)
        schedule = dispersed_gemm.grouped_schedule(
            m, n, k, block_m=block_m, block_k=block_k, working_set=w,
            bytes_per_el=bpe)
        model_bytes, vmem_acc = model["grouped"], model["vmem_acc_bytes"]
        name = f"{case}_W{w}_{prec}"
    counted = traffic.count(schedule)["total"]
    cuda_fn = (dispersed_gemm.matmul_dispersed_cuda if w == 0
               else dispersed_gemm.matmul_grouped_cuda)
    us = _routed(fn, cuda_fn, "gemm", prec, device, repeats)
    return dict(
        name=name, case=case, kernel="gemm", working_set=w, precision=prec,
        block_m=block_m, block_k=block_k, us_per_call=round(us, 1),
        flops=2 * m * n * k, counted_bytes=counted, model_bytes=model_bytes,
        model_agree=abs(counted - model_bytes) <= AGREE_RTOL * model_bytes,
        vmem_acc_bytes=vmem_acc)


def _routed(fn, cuda_fn, kernel: str, prec: str, device, repeats) -> float:
    """``_measure(fn)``, adding the launches it made on each route of
    ``cuda_fn`` to ``_ROUTES[kernel][prec]``."""
    before = (cuda_fn.launches_tc, cuda_fn.launches_fma)
    us = _measure(fn, device, repeats)
    routes = _ROUTES.setdefault(kernel, {}).setdefault(prec,
                                                       dict(tc=0, fma=0))
    routes["tc"] += cuda_fn.launches_tc - before[0]
    routes["fma"] += cuda_fn.launches_fma - before[1]
    return us


def _flash_point(case, b, h, s, d, prec, *, device, repeats) -> dict:
    bpe = _BYTES[prec]
    q, k, v = (_randn((b, h, s, d), 2 + i, prec, device) for i in range(3))
    model = flash_attention.hbm_traffic_model(
        b, h, s, s, d, block_q=FLASH_BLOCK, block_k=FLASH_BLOCK,
        bytes_per_el=bpe)
    counted = traffic.count(flash_attention.flash_schedule(
        b, h, s, s, d, block_q=FLASH_BLOCK, block_k=FLASH_BLOCK,
        bytes_per_el=bpe))["total"]
    fn = lambda: flash_attention.flash_attention(
        q, k, v, block_q=FLASH_BLOCK, block_k=FLASH_BLOCK)
    us = _routed(fn, flash_attention.flash_attention_cuda, "flash_attention",
                 prec, device, repeats)
    return dict(
        name=f"{case}_{prec}", case=case, kernel="flash",
        working_set=1, precision=prec, block_m=FLASH_BLOCK,
        block_k=FLASH_BLOCK, us_per_call=round(us, 1),
        flops=4 * b * h * s * s * d, counted_bytes=counted,
        model_bytes=model["flash"],
        model_agree=abs(counted - model["flash"])
        <= AGREE_RTOL * model["flash"],
        vmem_acc_bytes=model["vmem_acc_bytes"])


def _grid_fields(rows):
    keep = ("us_per_call", "flops", "counted_bytes", "model_bytes",
            "model_agree", "vmem_acc_bytes")
    return [{k: r[k] for k in
             ("case", "working_set", "precision") + keep} for r in rows]


def equal_vmem_points(m: int) -> list[tuple[int, int, int]]:
    """fig6 mirrored at accumulator granularity: (W, block_m, block_k)
    points with the same accumulator footprint W*block_m*n*4 — more,
    smaller registers vs fewer, taller ones at equal area."""
    pts = [(4, 64, 128), (2, 128, 128), (1, 256, 64)]
    return [(w, bm, bk) for (w, bm, bk) in pts
            if m % bm == 0 and (m // bm) % w == 0]


def run_measured(smoke: bool = False, repeats: int = 3, device="cuda"):
    """Execute the measured suite on ``device``.

    Returns ``(gemm_result, flash_result, rows)``: two labeled
    :class:`repro_torch.api.SweepResult` grids (axes ``case`` x
    ``working_set`` x ``precision`` and ``case`` x ``precision``) with the
    registry metrics derived, plus the flat row list (including the
    equal-footprint study rows, which vary ``block_m``/``block_k`` off the
    main grid).
    """
    dev = resolve_device(device)
    before = _counts()
    _ROUTES.clear()
    gemm_cases = SMOKE_GEMM_CASES if smoke else GEMM_CASES
    flash_cases = SMOKE_FLASH_CASES if smoke else FLASH_CASES
    w_axis = SMOKE_W_AXIS if smoke else W_AXIS
    precisions = ("f32",) if smoke else PRECISIONS
    repeats = 1 if smoke else repeats

    rows = []
    for case, (m, k, n) in gemm_cases.items():
        for w in w_axis:
            for prec in precisions:
                rows.append(_gemm_point(
                    case, m, k, n, w, prec, block_m=BLOCK_M,
                    block_k=BLOCK_K, device=dev, repeats=repeats))
    gemm_result = api.SweepResult.from_table(
        dict(case=tuple(gemm_cases), working_set=w_axis,
             precision=precisions),
        _grid_fields(rows),
        values=["us_per_call", "flops", "counted_bytes", "model_bytes",
                "model_agree", "vmem_acc_bytes"])
    gemm_result = (gemm_result.derive("arithmetic_intensity")
                   .derive("model_arithmetic_intensity")
                   .derive("achieved_gflops"))
    # time normalized to the W=0 spill/fill extreme: > 1 means the compact
    # working set pays off (Fig 4's economics, measured)
    rel = gemm_result.normalize("us_per_call",
                                baseline=dict(working_set=0))
    for r in rows:
        r["speedup_vs_dispersed"] = round(
            1.0 / rel.value("us_per_call", case=r["case"],
                            working_set=r["working_set"],
                            precision=r["precision"]), 3)
        r["ai_measured"] = round(gemm_result.value(
            "arithmetic_intensity", case=r["case"],
            working_set=r["working_set"], precision=r["precision"]), 2)
        r["ai_model"] = round(gemm_result.value(
            "model_arithmetic_intensity", case=r["case"],
            working_set=r["working_set"], precision=r["precision"]), 2)

    flash_rows = []
    for case, (b, h, s, d) in flash_cases.items():
        for prec in precisions:
            flash_rows.append(_flash_point(
                case, b, h, s, d, prec, device=dev, repeats=repeats))
    flash_result = api.SweepResult.from_table(
        dict(case=tuple(flash_cases), precision=precisions),
        [{k: r[k] for k in ("case", "precision", "us_per_call", "flops",
                            "counted_bytes", "model_bytes", "model_agree",
                            "vmem_acc_bytes")} for r in flash_rows],
        values=["us_per_call", "flops", "counted_bytes", "model_bytes",
                "model_agree", "vmem_acc_bytes"])
    flash_result = (flash_result.derive("arithmetic_intensity")
                    .derive("model_arithmetic_intensity")
                    .derive("achieved_gflops"))
    for r in flash_rows:
        r["speedup_vs_dispersed"] = ""
        r["ai_measured"] = round(flash_result.value(
            "arithmetic_intensity", case=r["case"],
            precision=r["precision"]), 2)
        r["ai_model"] = round(flash_result.value(
            "model_arithmetic_intensity", case=r["case"],
            precision=r["precision"]), 2)
    rows += flash_rows

    # equal-footprint study (fig6 at accumulator granularity): fixed
    # accumulator budget, which (W, block_m, block_k) schedule wins?
    equal_vmem = []
    if not smoke:
        for case, (m, k, n) in gemm_cases.items():
            pts = []
            for w, bm, bk in equal_vmem_points(m):
                p = _gemm_point(case, m, k, n, w, "f32", block_m=bm,
                                block_k=bk, device=dev, repeats=repeats)
                p["name"] = f"eqvmem_{case}_W{w}_bm{bm}_bk{bk}"
                p["speedup_vs_dispersed"] = ""
                p["ai_measured"] = round(
                    p["flops"] / p["counted_bytes"], 2)
                p["ai_model"] = round(p["flops"] / p["model_bytes"], 2)
                pts.append(p)
            if not pts:
                continue
            budgets = {p["vmem_acc_bytes"] for p in pts}
            measured_win = min(pts, key=lambda p: p["us_per_call"])
            # Equal budget => equal groups => the closed form often
            # predicts a byte tie; measured timing breaks it.
            best_bytes = min(p["model_bytes"] for p in pts)
            model_wins = [p["name"] for p in pts
                          if p["model_bytes"] == best_bytes]
            equal_vmem.append(dict(
                case=case, vmem_budget_bytes=sorted(budgets),
                points=[dict(working_set=p["working_set"],
                             block_m=p["block_m"], block_k=p["block_k"],
                             us_per_call=p["us_per_call"],
                             model_bytes=p["model_bytes"]) for p in pts],
                measured_winner=measured_win["name"],
                model_winner=(model_wins[0] if len(model_wins) == 1
                              else "tie(" + ", ".join(model_wins) + ")")))
            rows += pts

    after = _counts()
    _STATS.clear()
    _STATS.update(
        device=str(dev),
        kernel_launches={n: after[n][0] - before[n][0] for n in after},
        plain_calls={n: after[n][1] - before[n][1] for n in after},
        route_launches={kernel: {p: dict(r) for p, r in precs.items()}
                        for kernel, precs in _ROUTES.items()})
    global _LAST_EXTRA
    _LAST_EXTRA = dict(
        rows=[{k: (v if not isinstance(v, bool) else bool(v))
               for k, v in r.items()} for r in rows],
        equal_vmem=equal_vmem,
        pareto={case: gemm_result.pareto(
            "vmem_acc_bytes", "us_per_call", case=case, precision=prec)
            for case in gemm_cases for prec in precisions[:1]},
        axes=dict(case=list(gemm_cases) + list(flash_cases),
                  working_set=list(w_axis), precision=list(precisions)),
        device=str(dev),
    )
    return gemm_result, flash_result, rows


# ---------------------------------------------------------------------------
# Front door.
# ---------------------------------------------------------------------------

_HEADER = ["name", "us_per_call", "working_set", "precision",
           "speedup_vs_dispersed", "ai_measured", "ai_model", "model_agree",
           "counted_bytes", "model_bytes", "vmem_acc_bytes"]


def main(max_events: int | None = None, device="cuda") -> list[dict]:
    smoke = max_events is not None and max_events <= 5000
    _, _, rows = run_measured(smoke=smoke, device=device)
    common.emit(rows, _HEADER)
    for study in _LAST_EXTRA.get("equal_vmem", ()):
        print(f"# equal-VMEM {study['case']}: measured winner "
              f"{study['measured_winner']}, model winner "
              f"{study['model_winner']}")
    return rows


def json_extra() -> dict:
    """Per-point measured/model rows, the equal-footprint winners and the
    footprint-vs-time Pareto fronts of the last run."""
    return _LAST_EXTRA


def perf_stats() -> dict:
    """Kernel launches and plain-twin calls of the last ``run_measured``,
    per kernel, counted in the wrappers; and its GEMM and attention
    launches per precision and route (``route_launches["gemm"]``,
    ``route_launches["flash_attention"]``)."""
    return dict(_STATS)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced grid (one shape, f32, W in 0..2)")
    args = ap.parse_args()
    main(max_events=1000 if args.smoke else None, device=args.device)
    print(f"# device {args.device}: {perf_stats()}")
