"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

  1. build     compile every CUDA kernel of the port from src/ (nvcc,
               sm_90a), one nvcc per source, all started together, print
               flash_tc's and rmsnorm_vec's registers and spills, and hold
               dispersed_gemm.tc_plan, flash_attention.flash_plan and
               rmsnorm.rmsnorm_plan against the built kernels' tiles;
  2. kernels   hold each kernel against its plain-torch twin on the card at
               the main paths' shapes and a few edge shapes: K5 flash
               attention (bf16 on the tensor-core route: causal and not,
               ragged, GQA in the strided layout, every head dim; f32 and
               int8 on the CUDA-core route; a bf16 input the route refuses
               raises), K3 grouped and K4 dispersed
               GEMM (f32 on the CUDA-core route; bf16 and int8 on the
               tensor-core route, int8 exactly; K3 bitwise equal across
               W, K4 bitwise equal to K3 on the tensor cores, bf16 W = 3
               in a cluster of 3), K6 RMSNorm (d = 3072 and 4096 in bf16
               and f32 on the vec route, row counts that do not fill the
               persistent grid; a bf16 d no multiple of 8, an unaligned
               view and a d above the register limit on general; each
               launch counted on the route its plan names);
  3. engine    K1, the engine scan (two kernels: K1a, the cVRF pass,
               and K1b, the L1 pass), against the one-walk plain twin
               (on the host's CPU) at reduced size, bitwise on all three
               counter sets, and K1a and K1b each against its own plain
               version on its own inputs: every rvv program unfolded and
               folded on the reference's conformance points and M = 6
               machine grid, and lanes on the decision edges
               (capacities 1, 2, 32, every policy);
     trace     on the host: every rvv program built at its paper size
               and expanded into the engine's event matrices (T, active
               registers, bytes), T held to TRACE_T; at reduced size the
               full-VRF interpreter against the dispersed one (FIFO,
               capacity 8), bitwise;
     engine    the main path at paper size on the card: simulate_grid
               folded as the reference's Session folds (re-running
               unfolded what its rule re-runs), held exactly to
               BENCH_core.json's table3 cycles and pareto keys, both
               kernels launched; table3 unfolded beside it; the same
               checks as above on the main path's inputs cut to 2,048
               rows; the device times of K1, K1a and K1b (folded table3
               grid, unfolded resnet50_l10, folded 4 KB pareto grid)
               beside their bounds, their longest chains counted from the
               data and the host's prepare and _stack seconds;
  4. prefill   full-width phi3-mini-3.8b (random weights from a seeded
               generator): Model.prefill on 4 x 512 tokens with the flash
               kernel vs the plain sdpa path, counting kernel launches (all
               on the tensor-core route), and
               a reduced f32 model on the card vs the same on the CPU;
  5. serve     a ServeEngine with dispersed KV pages answers a seeded
               steady-traffic scenario at full width;
  6. roofline  the measured roofline (repro_torch.benchmarks.roofline) on
               the card: every row's schedule bytes agree with the closed
               form, the row count is the reference grid's, K3, K4 and
               K5 were launched, the bf16/int8 GEMM rows and the bf16
               attention row on the tensor-core route, the other rows on
               the FMA route; one call's time from idle vs back to back
               vs queued behind a sleep kernel (the device alone) vs the
               host's issue time at two GEMM points, the attention
               point in bf16 and f32 and K6 and F.rms_norm at (8192,
               4096) and (2048, 3072) bf16; then vmem_dispersion's spot
               check;
  7. timing    each kernel at its main shape (K5 at the prefill shape,
               timed with scaled_dot_product_attention in FLASH_ROUNDS
               rounds, K3 W=1/W=4 and K4 at granite-8b's MLP GEMM, where
               K3 is bitwise equal across W and K4 to K3 in bf16 and int8,
               timed in GEMM_ROUNDS rounds; K6 with F.rms_norm in
               NORM_ROUNDS rounds at (8192, 4096) bf16 and f32 and
               (2048, 3072) bf16) beside its
               bound, its plain twin and the library call computing the
               same function.

The last lines are the kernels' JSON record, the card's name and power
limit, and the result line {"ok": true, "device": {...}}.  Without a CUDA
device the script prints no result and exits 1.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.benchmarks import roofline, vmem_dispersion  # noqa: E402
from repro_torch import rvv  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import (events, interpreter, isa, policies,  # noqa: E402
                              simulator)
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import engine_scan as es  # noqa: E402
from repro_torch.kernels import dispersed_gemm as dg  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels.ref import cast_like  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import TRAFFIC_MIXES, ServeEngine, generate  # noqa: E402

ARCH = "phi3-mini-3.8b"
PREFILL_BATCH, PREFILL_LEN = 4, 512
# granite-8b's MLP GEMM, vmem_dispersion's shape: tokens x d x d_ff
GEMM_M, GEMM_K, GEMM_N = 8192, 4096, 14336
GEMM_BLOCK_M, GEMM_BLOCK_K = 128, 512
# K3 W=1, K3 W=4 and K4 at that shape are timed in this many rounds
GEMM_ROUNDS = 8
# K5 and scaled_dot_product_attention at the prefill shape, likewise
FLASH_ROUNDS = 8
NORM_ROWS, NORM_D = 8192, 4096
# K6 and F.rms_norm are timed in this many rounds of NORM_ITERS calls
NORM_ROUNDS, NORM_ITERS = 8, 50
# Instructions of each rvv program at its paper_params, in the registry's
# order (the reference package's build gives the same counts): the trace
# lengths the engine kernel must take
TRACE_T = {"pathfinder": 1147, "jacobi2d": 247040, "somier": 1052674,
           "gemv": 100097, "dropout": 98304, "conv2d_7x7": 1000126,
           "densenet121_l105": 885537, "resnet50_l10": 9671553,
           "flashattention2": 2452400, "conv2d_batched": 45729,
           "mha": 253120}
# The cVRF the functional check runs: FIFO at this capacity
TRACE_CHECK_CAPACITY = 8
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,          # dense tensor-core bf16
              torch.float32: 67e12}            # FP32 outside tensor cores
# Kernel vs plain twin on the card.  f32: same arithmetic, other summation
# order and exp implementation over up to 512 terms.  bf16: both accumulate
# in f32 and round the output once; the tensor-core route also rounds P to
# bf16 for the P V product (2^-9 relative per term).
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
# GEMM (K3/K4) vs plain twin, (atol, rtol).  f32: FP32 FMAs in one chain
# vs cuBLAS's f32 order (no TF32).  bf16: one bf16 ulp (2^-7 relative),
# plus an absolute term for outputs near 0, where the f32 summation order
# (about 1e-3 at k = 4096) decides the rounding.  int8: exact.
GEMM_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 2.0 ** -7)}
# RMSNorm vs plain twin: f32 rsqrtf and another summation order; bf16 one
# ulp of the output.
NORM_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-6, 2.0 ** -7)}
# K5 on int8 vs its twin (check_int8_attention): outputs whose f32 value
# lies within INT8_NEAR of a nonzero integer may differ by 1, and at most
# INT8_EXCUSED_SHARE of the outputs are excused so; all others are equal.
# INT8_NEAR is about 100x the f32 difference of kernel and twin that
# int8-valued inputs (scores of order 10) give, ~1e-5.
INT8_NEAR = 2.0 ** -10
INT8_EXCUSED_SHARE = 0.01
# host_vs_device holds the stream with a sleep kernel of this many cycles
# (about 25 ms at the H100's clocks of at most 2 GHz) while it queues the
# calls it times on the device alone
QUEUE_SLEEP_CYCLES = 50_000_000


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def cuda_ms(fn, *, warmup: int = 3, iters: int = 20) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ----------------------------------------------------------------- kernels --

def randn(gen, shape, dtype) -> torch.Tensor:
    """Standard-normal values on the card; int8 takes 2 * N(0, 1)
    truncated (values in about [-8, 8])."""
    if dtype == torch.int8:
        x = torch.randn(shape, generator=gen, device="cuda")
        return cast_like(2 * x, torch.int8)
    return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)


def _qkv(gen, q_shape, kv_shape, dtype, *, bshd=False):
    """Random q, k, v on the card; ``bshd`` makes them (B,S,H,D) tensors
    viewed as (B,H,S,D), the strided layout the model's prefill passes."""
    def one(shape):
        if bshd:
            b, h, s, d = shape
            return randn(gen, (b, s, h, d), dtype).transpose(1, 2)
        return randn(gen, shape, dtype)
    return one(q_shape), one(kv_shape), one(kv_shape)


def attention_bound_ms(q, k, v, causal: bool) -> tuple[float, str]:
    """Least time for the function on these inputs: each input read and
    the output written once over HBM, or the unmasked (row, col) pairs'
    2 * 2D flops over the dtype's peak, whichever is larger."""
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    rows = np.arange(sq)
    pairs = (np.minimum(rows + 1, sk).sum() if causal else sq * sk)
    flops = 4.0 * d * b * hq * float(pairs)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def phase_kernels() -> float:
    """K5 against its plain twin, each case on its dtype's route; then a
    bf16 input the tensor-core route refuses.  Returns the max |err| of
    the bf16 cases."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # (name, q shape, kv shape, dtype, causal, bshd)
        ("prefill", (4, 32, 512, 96), (4, 32, 512, 96), torch.bfloat16,
         True, True),
        ("prefill_full", (4, 32, 512, 96), (4, 32, 512, 96),
         torch.bfloat16, False, True),
        ("ragged_bf16_full", (1, 8, 200, 96), (1, 8, 328, 96),
         torch.bfloat16, False, False),
        ("ragged_bf16_causal", (1, 8, 200, 96), (1, 8, 328, 96),
         torch.bfloat16, True, False),
        ("gqa_32_8_d128_bshd", (2, 32, 256, 128), (2, 8, 256, 128),
         torch.bfloat16, False, True),
        ("roofline_bf16", (1, 2, 256, 64), (1, 2, 256, 64), torch.bfloat16,
         False, False),
        ("bf16_d32_causal", (1, 4, 192, 32), (1, 4, 192, 32),
         torch.bfloat16, True, False),
        ("short_q_bf16_causal", (1, 2, 40, 64), (1, 2, 300, 64),
         torch.bfloat16, True, False),
        ("f32_causal", (2, 8, 384, 96), (2, 8, 384, 96), torch.float32,
         True, False),
        ("f32_full", (2, 8, 384, 96), (2, 8, 384, 96), torch.float32,
         False, False),
        ("gqa_32_8_d128", (2, 32, 256, 128), (2, 8, 256, 128),
         torch.bfloat16, True, False),
        ("ragged_sq_ne_sk", (1, 8, 200, 64), (1, 8, 328, 64), torch.float32,
         False, False),
        ("roofline_int8", (1, 2, 256, 64), (1, 2, 256, 64), torch.int8,
         False, False),
        ("int8_causal", (2, 8, 384, 96), (2, 8, 384, 96), torch.int8,
         True, False),
    ]
    bf16_err = 0.0
    counted = fa.flash_attention_cuda
    for name, qs, ks, dtype, causal, bshd in cases:
        q, k, v = _qkv(gen, qs, ks, dtype, bshd=bshd)
        route = fa.flash_plan(q, k, v)["route"]
        before = counted.launches_tc, counted.launches_fma
        got = ops.flash_attention(q, k, v, causal=causal, block_q=qs[2],
                                  block_k=ks[2])
        torch.cuda.synchronize()
        ran = (counted.launches_tc - before[0],
               counted.launches_fma - before[1])
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        err = (got.float() - want.float()).abs()
        if dtype == torch.int8:
            ok, extra = check_int8_attention(q, k, v, causal, got, want)
        else:
            atol, rtol = TOL[dtype]
            ok = bool((err <= atol + rtol * want.float().abs()).all())
            extra = dict(atol=atol, rtol=rtol)
        log("kernels", case=name, q=list(qs), kv=list(ks),
            dtype=str(dtype).split(".")[-1], causal=causal, bshd=bshd,
            route=route, launches_tc_fma=list(ran),
            max_abs_err=float(err.max()), mismatched=int((err > 0).sum()),
            **extra, ok=ok)
        check(ok and bool(torch.isfinite(got.float()).all()),
              f"flash_attention disagrees with its plain twin on {name}")
        want_route = "tc" if dtype == torch.bfloat16 else "fma"
        check(route == want_route and ran == ((1, 0) if route == "tc"
                                              else (0, 1)),
              f"flash_attention {name}: route {route}, launches {ran}")
        if dtype == torch.bfloat16:
            bf16_err = max(bf16_err, float(err.max()))

    # A bf16 head stride of 100 elements (200 bytes) is no multiple of 16
    # bytes: the tensor-core route refuses it, and nothing launches.
    x = randn(gen, (1, 64, 2, 100), torch.bfloat16)[..., :96].transpose(1, 2)
    before = counted.launches_tc, counted.launches_fma
    try:
        ops.flash_attention(x, x, x, causal=True)
        refused = False
    except ValueError as e:
        refused = "multiples of 16 bytes" in str(e)
    torch.cuda.synchronize()
    ran = (counted.launches_tc - before[0], counted.launches_fma - before[1])
    log("kernels", case="bf16_stride_200_bytes_refused", refused=refused,
        launches_tc_fma=list(ran))
    check(refused and ran == (0, 0),
          f"flash_attention took a 200-byte head stride: {refused}, {ran}")
    return bf16_err


def check_int8_attention(q, k, v, causal, got, want) -> tuple[bool, dict]:
    """K5 on int8 against the twin, which truncates its f32 result toward
    zero and saturates.  The kernel computes the same f32 values in another
    order, so the two can truncate to neighbouring integers only where the
    twin's f32 value lies within that difference of a nonzero integer.
    Those outputs (within INT8_NEAR of one) are excused and must be within
    1 and at most INT8_EXCUSED_SHARE of all; every other output must be
    equal.  A kernel that rounds to nearest, or is off by one, fails.  The
    window is held against the kernel's own f32 difference on these
    values: the f32 instantiation on q, k, v widened to f32."""
    f32 = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                   causal=causal)
    f32_kernel = ops.flash_attention(q.float(), k.float(), v.float(),
                                     causal=causal, block_q=q.shape[2],
                                     block_k=k.shape[2])
    f32_diff = float((f32_kernel - f32).abs().max())
    near = f32.round()
    excused = ((f32 - near).abs() <= INT8_NEAR) & (near != 0)
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    n_excused = int(excused.sum())
    ok = (torch.equal(got[~excused], want[~excused])
          and bool((diff[excused] <= 1).all())
          and n_excused <= INT8_EXCUSED_SHARE * got.numel()
          and f32_diff <= INT8_NEAR
          and torch.equal(want, cast_like(f32, torch.int8)))
    return ok, dict(excused=n_excused, excused_max=int(
        INT8_EXCUSED_SHARE * got.numel()), near=INT8_NEAR,
        kernel_f32_vs_twin_f32=f32_diff)


def _close(got, want, atol, rtol) -> tuple[bool, float]:
    err = (got.float() - want.float()).abs()
    return (bool((err <= atol + rtol * want.float().abs()).all())
            and bool(torch.isfinite(got.float()).all()), float(err.max()))


def check_gemm(name, a, b, *, w, block_m, block_k):
    """K3 (w >= 1) or K4 (w == 0) against its plain twin; int8 exactly.
    Returns the kernel's output and its max |err|."""
    if w:
        got = ops.matmul(a, b, working_set=w, block_m=block_m,
                         block_k=block_k)
        want = dg.matmul_grouped_plain(a, b, working_set=w, block_m=block_m,
                                       block_k=block_k)
    else:
        got = ops.matmul_dispersed(a, b, block_m=block_m, block_k=block_k)
        want = dg.matmul_dispersed_plain(a, b, block_m=block_m,
                                         block_k=block_k)
    torch.cuda.synchronize()
    check(got.dtype == a.dtype and got.shape == want.shape,
          f"{name}: {got.dtype} {tuple(got.shape)}")
    if a.dtype == torch.int8:
        ok, err = bool(torch.equal(got, want)), float(
            (got.float() - want.float()).abs().max())
        atol = rtol = 0.0
    else:
        atol, rtol = GEMM_TOL[a.dtype]
        ok, err = _close(got, want, atol, rtol)
    plan = dg.tc_plan(a.shape[0], b.shape[1], a.shape[1], block_m=block_m,
                      block_k=block_k, working_set=w, dtype=a.dtype)
    log("kernels", case=name, kernel="matmul_grouped" if w else
        "matmul_dispersed", mkn=[a.shape[0], a.shape[1], b.shape[1]],
        working_set=w, block_m=block_m, block_k=block_k,
        dtype=str(a.dtype).split(".")[-1], route=plan["route"],
        cluster=plan["cluster"], n_tile=plan["n_tile"], max_abs_err=err,
        atol=atol, rtol=rtol, ok=ok)
    check(ok, f"{name} disagrees with its plain twin")
    return got, err


def phase_gemm_kernels() -> dict:
    """K3 (W = 1, 2, 4) and K4 against their plain twins at the roofline's
    shapes, the equal-footprint points and a ragged n, in f32 (FMA route),
    bf16 and int8 (tensor-core route); K3 bitwise equal across W and K4
    bitwise equal to K3 on the tensor cores; W = 3 on the tensor cores
    and its refusal on the FMA route.  Returns each kernel's max |err|."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    errs = {"matmul_grouped": 0.0, "matmul_dispersed": 0.0}
    cases = [(m, 512, n, w, 64, 128) for (m, n) in ((256, 256), (512, 256))
             for w in (0, 1, 2, 4)]
    cases += [(512, 512, 256, w, bm, bk) for (w, bm, bk) in
              ((4, 64, 128), (2, 128, 128), (1, 256, 64))]
    cases += [(256, 512, 200, 2, 64, 128), (256, 512, 200, 0, 64, 128)]
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        k3_out = {}        # (m, k, n, block_m) -> K3's output at W
        k4_vs_k3 = []
        for m, k, n, w, bm, bk in cases:
            gen.manual_seed(m * k + n)    # same a, b for every W of a shape
            a, b = randn(gen, (m, k), dtype), randn(gen, (k, n), dtype)
            name = (f"gemm_{m}x{k}x{n}_" + (f"W{w}" if w else "dispersed")
                    + f"_bm{bm}_bk{bk}_{str(dtype).split('.')[-1]}")
            got, err = check_gemm(name, a, b, w=w, block_m=bm, block_k=bk)
            kernel = "matmul_grouped" if w else "matmul_dispersed"
            errs[kernel] = max(errs[kernel], err)
            if w:
                k3_out.setdefault((m, k, n, bm), {})[w] = got
            elif dtype != torch.float32:
                k4_vs_k3.append((m, k, n, bm, got))
        for key, outs in k3_out.items():
            ws = sorted(outs)
            same = all(torch.equal(outs[ws[0]], outs[x]) for x in ws[1:])
            if len(ws) > 1:
                log("kernels", case="grouped_bitwise_across_W", mkn=list(
                    key[:3]), block_m=key[3], working_sets=ws,
                    dtype=str(dtype).split(".")[-1], equal=same)
            check(same, f"matmul_grouped output depends on W at {key}")
        # K4 on the tensor cores runs K3's sequence of wgmmas, with exact
        # f32 fills between its launches: bitwise equal.
        for m, k, n, bm, got in k4_vs_k3:
            k3 = k3_out[(m, k, n, bm)]
            same = all(torch.equal(got, o) for o in k3.values())
            log("kernels", case="dispersed_equals_grouped", mkn=[m, k, n],
                block_m=bm, dtype=str(dtype).split(".")[-1],
                working_sets=sorted(k3), equal=same)
            check(same, f"matmul_dispersed != matmul_grouped at "
                        f"{(m, k, n, bm)} in {dtype}")
    # W = 3: a cluster of 3 CTAs on the tensor cores; on the FMA route
    # W * block_m = 192 rows is no power of two, refused with ValueError.
    for dtype in (torch.bfloat16, torch.int8):
        a = randn(gen, (384, 128), dtype)
        b = randn(gen, (128, 256), dtype)
        got, err = check_gemm(f"gemm_384x128x256_W3_bm64_"
                              f"{str(dtype).split('.')[-1]}", a, b, w=3,
                              block_m=64, block_k=128)
        w1 = ops.matmul(a, b, working_set=1, block_m=64, block_k=128)
        check(torch.equal(got, w1), f"W=3 and W=1 differ in {dtype}")
        errs["matmul_grouped"] = max(errs["matmul_grouped"], err)
    a = randn(gen, (384, 128), torch.float32)
    b = randn(gen, (128, 256), torch.float32)
    try:
        ops.matmul(a, b, working_set=3, block_m=64, block_k=128)
        refused = False
    except ValueError as e:
        refused = "power of two" in str(e)
    log("kernels", case="grouped_f32_cta_rows_192_refused", refused=refused)
    check(refused, "matmul_grouped took a CTA of 192 rows on the FMA route")
    return errs


# K6's cases (shape, dtype, how x is made, route): the reference test's
# shapes, the main norm widths d = 3072 (the prefill's) and 4096 in both
# dtypes, row counts that do not fill the persistent grid's last pass,
# and what the vec route leaves to general (a bf16 d no multiple of 8, a
# view whose base is not 16-byte aligned, a d above the register-resident
# limit).
NORM_CASES = [
    ((2, 128, 512), torch.float32, "contiguous", "vec"),
    ((2, 64, 1024), torch.bfloat16, "contiguous", "vec"),
    ((3, 100), torch.float32, "contiguous", "vec"),
    ((2048, 3072), torch.bfloat16, "contiguous", "vec"),
    ((2048, 3072), torch.float32, "contiguous", "vec"),
    ((NORM_ROWS, NORM_D), torch.bfloat16, "contiguous", "vec"),
    ((NORM_ROWS, NORM_D), torch.float32, "contiguous", "vec"),
    ((5003, 4096), torch.bfloat16, "contiguous", "vec"),
    ((1111, 3072), torch.float32, "contiguous", "vec"),
    ((300, 1004), torch.bfloat16, "contiguous", "general"),
    ((512, 4096), torch.bfloat16, "offset", "general"),
    ((64, 16384), torch.bfloat16, "contiguous", "general"),
]


def _norm_input(gen, shape, dtype, how):
    """x on the card; ``offset`` makes it a contiguous view one element
    past a 16-byte boundary."""
    if how == "offset":
        n = int(np.prod(shape))
        return randn(gen, (n + 1,), dtype)[1:].view(shape)
    return randn(gen, shape, dtype)


def check_norm_plan() -> None:
    """rmsnorm.rmsnorm_plan's tile against the built kernel's
    (rmsnorm_tile) for every K6 case's route, d and dtype, and the
    occupancy the vec route was built for."""
    seen = set()
    for shape, dtype, how, route in NORM_CASES:
        if (route, shape[-1], dtype) in seen:
            continue
        seen.add((route, shape[-1], dtype))
        d = shape[-1]
        buf = torch.empty(2 * d + 1, dtype=dtype, device="cuda")
        x = (buf[1:] if how == "offset" else buf[:2 * d]).view(2, d)
        plan = rn.rmsnorm_plan(x)
        want = {key: plan[key] for key in rn.TILE_KEYS}
        built = rn.built_tile(route, d, dtype)
        resident = built.pop("resident_ctas_per_sm")
        log("build", rmsnorm_tile=f"{route} d={d} {str(dtype)[6:]}",
            **built, resident_ctas_per_sm=resident,
            rmsnorm_plan_agrees=built == want and plan["route"] == route)
        check(plan["route"] == route and built == want,
              f"rmsnorm_plan {plan} != the built kernel's {built} on "
              f"{route} at d={d} {dtype}")
        check(route == "general" or resident >= rn.VEC_CTAS_PER_SM,
              f"rmsnorm_vec at d={d} {dtype}: {resident} CTAs resident "
              f"per SM, the grid assumes {rn.VEC_CTAS_PER_SM}")


def check_engine_plan() -> None:
    """engine_scan.engine_scan_plan's tiles (K1a and K1b) against the
    built kernels' (engine_scan_tile) at both L1 geometries the main path
    runs."""
    for kb in PARETO_L1_KB:
        m = _l1_machine(kb)
        plan = es.engine_scan_plan(m.l1_sets, m.l1_ways)["tile"]
        built = es.built_tile(m.l1_sets, m.l1_ways)
        log("build", engine_scan_tile=f"{m.l1_sets}x{m.l1_ways}", **built,
            engine_scan_plan_agrees=built == plan)
        check(built == plan, f"engine_scan_plan {plan} != the built "
              f"kernels' {built} at {m.l1_sets} x {m.l1_ways}")


def phase_norm_kernels() -> tuple[float, dict]:
    """K6 against its plain twin on every NORM_CASES case, each launch
    counted on the route its plan names.  Returns the max |err| and the
    launches by route."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = 0.0
    fn = rn.rmsnorm_cuda
    held = {route: 0 for route in fn.routes}
    for shape, dtype, how, route in NORM_CASES:
        x = _norm_input(gen, shape, dtype, how)
        scale = 1.0 + 0.1 * randn(gen, (shape[-1],), torch.float32)
        plan = rn.rmsnorm_plan(x)
        before = fn.by_route()
        got = rn.rmsnorm(x, scale, block_rows=1)
        torch.cuda.synchronize()
        ran = {r: n - before[r] for r, n in fn.by_route().items()}
        want = rn.rmsnorm_plain(x, scale)
        atol, rtol = NORM_TOL[dtype]
        ok, err = _close(got, want, atol, rtol)
        ok = ok and got.dtype == dtype and got.shape == x.shape
        log("kernels", case=f"rmsnorm_{'x'.join(map(str, shape))}",
            dtype=str(dtype).split(".")[-1], layout=how,
            route=plan["route"], threads_per_row=plan["threads_per_row"],
            rows_per_cta=plan["rows_per_cta"], launches=json.dumps(ran),
            max_abs_err=err, atol=atol, rtol=rtol, ok=ok,
            **({"why": plan["why"]} if "why" in plan else {}))
        check(ok, f"rmsnorm disagrees with its plain twin on {shape} "
                  f"{dtype} {how}")
        check(plan["route"] == route and ran == {
            r: int(r == route) for r in ran},
            f"rmsnorm {shape} {dtype} {how}: route {plan['route']}, "
            f"launches {ran}, want one on {route}")
        held[route] += 1
        worst = max(worst, err)
    return worst, held


# ------------------------------------------------------------------- trace --

def phase_trace() -> dict:
    """The trace layer on the host: build every rvv program at its
    paper_params and expand it into the engine's event matrices, printing
    the sizes the engine kernel takes (instructions T, active vector
    registers, the matrices' bytes as int32); T must equal TRACE_T.  Then,
    at reduced_params, the full-VRF interpreter against the dispersed one
    (FIFO, TRACE_CHECK_CAPACITY registers): memory and registers bitwise
    equal, and the outputs within the kernel's tolerance of its
    reference.  Returns the paper-size programs by name (the engine
    phase runs them)."""
    check(list(rvv.BENCHMARKS) == list(TRACE_T),
          f"rvv registry order {list(rvv.BENCHMARKS)}")
    t_phase = time.perf_counter()
    sizes, programs = {}, {}
    for name, bench in rvv.BENCHMARKS.items():
        t0 = time.perf_counter()
        prog = programs[name] = bench.build(**bench.paper_params).program
        t1 = time.perf_counter()
        ev = events.expand(prog)
        t2 = time.perf_counter()
        nbytes = sum(4 * a.size for a in vars(ev).values()
                     if isinstance(a, np.ndarray))
        sizes[name] = dict(T=prog.num_instructions,
                           active_vregs=len(prog.active_vregs()),
                           event_bytes_int32=nbytes)
        log("trace", program=name, params=json.dumps(bench.paper_params),
            **sizes[name], want_T=TRACE_T[name], events=ev.num_events,
            build_s=round(t1 - t0, 3), expand_s=round(t2 - t1, 3))
        check(prog.num_instructions == TRACE_T[name],
              f"{name}: T = {prog.num_instructions}, want {TRACE_T[name]}")
        del ev

        small = bench.build(**bench.reduced_params)
        full = interpreter.run(small.program)
        disp = interpreter.run_dispersed(small.program, TRACE_CHECK_CAPACITY,
                                         policies.FIFO)
        same = (np.array_equal(full.memory.view(np.int32),
                               disp.memory.view(np.int32))
                and np.array_equal(full.vregs.view(np.int32),
                                   disp.vregs.view(np.int32)))
        rvv.check(small, full.memory)          # raises if off
        log("trace", program=name, check="run_vs_run_dispersed",
            T=small.program.num_instructions, capacity=TRACE_CHECK_CAPACITY,
            policy="fifo", hits=disp.vrf_hits, misses=disp.vrf_misses,
            spills=disp.spills, fills=disp.fills, equal=same)
        check(same, f"{name}: run and run_dispersed differ")
    seconds = time.perf_counter() - t_phase
    log("trace", programs=len(sizes), seconds=round(seconds, 2),
        largest=max(sizes, key=lambda n: sizes[n]["T"]))
    return programs


# ------------------------------------------------------------------ engine --

# K1 is held bitwise to its plain twin (run on the host's CPU) at reduced
# size on the reference's conformance points (tests/test_golden_counters.py
# CONF_POINTS) and its M = 6 machine grid (tests/test_machine_grid.py),
# every program in one batch, unfolded and folded.
CONF_POINTS = (
    (3, policies.FIFO, simulator.MachineParams(mem_latency=1)),
    (4, policies.LRU, simulator.MachineParams(mem_latency=10,
                                              uop_hit_cycles=2)),
    (8, policies.OPT, simulator.MachineParams(mem_latency=5,
                                              l1_hit_cycles=1)),
)
M6 = simulator.MachineSweep.product((1, 3, 10), uop_hit_cycles=(1, 2))
# The reduced traces are too short to fold after the 16 KB L1's warm-up
# (2 x 512 lines), so the folded check plans them with this warm-up
FOLD_CHECK_WARM_LINES = 16
# Lanes on the decision edges: capacities 1 and 2 (no slot evictable under
# the vd check's two locks: the victim is slot 0), the full VRF, every
# policy, with and without alloc_no_fetch, on the smallest programs
HAZARD_SWEEP = simulator.SweepConfig.product(
    (1, 2, 32), (policies.FIFO, policies.LRU, policies.LFU, policies.OPT),
    (False, True))
HAZARD_PROGRAMS = ("pathfinder", "gemv", "densenet121_l105")
# BENCH_core.json's suites all ran folded through the reference's
# api.Session, which re-runs a program unfolded when its fold certificate
# failed at some point of its grid and it has at most REFINE_MAX_ROWS
# instructions (src/repro/api.py REFINE_MAX_ROWS and Session._refine)
REFINE_MAX_ROWS = 400_000
# The pareto suite's grid (benchmarks/pareto_frontier.py): capacities x L1
# sizes in KB, 2 ways of 32-byte lines, FIFO, the default latencies
PARETO_CAPS = (3, 4, 5, 6, 8, 10, 12, 16, 32)
PARETO_L1_KB = (4, 16)
ENGINE_ITERS = 3
# K1 is also held to its twin on the paper-size main path's inputs, each
# trace cut to this many rows
ENGINE_CHECK_ROWS = 2048
# K1's operations bound counts, per lane: 3 ops (tag compare, free test,
# victim metric) on each of the 32 slots for a REG access to a cVRF, and 2
# (tag and age compare) on each way for a MEM access
ENGINE_OPS_PER_REG = 3 * 32
ENGINE_OPS_PER_WAY = 2


def _l1_machine(kbytes: int) -> simulator.MachineParams:
    return simulator.MachineParams(l1_sets=kbytes * 1024 // 32 // 2,
                                   l1_ways=2)


def _engine_inputs(preps, sweep, machines):
    """The packed (P, T, NCOL) rows and the other inputs of one engine
    call over ``preps``, as simulate_grid gives them to K1 (the A/B period
    counters only when a trace is folded)."""
    lengths = [p.num_rows for p in preps]
    arrays, spill0s = simulator._stack(preps)
    cfg = (sweep.capacity, sweep.policy, sweep.alloc_no_fetch)
    mach = (machines.l1_hit_cycles, machines.uop_hit_cycles,
            machines.mem_latency)
    kw = dict(l1_sets=machines.l1_sets, l1_ways=machines.l1_ways,
              track_ab=any(p.num_folds for p in preps), lengths=lengths)
    return es.pack(arrays), spill0s, cfg, mach, kw


def engine_bound_ms(x, cfg, kw, machines: int) -> tuple[float, str]:
    """Least time for K1's work on the packed rows x: the larger of its
    bytes over HBM (the rows each program walks, read once whatever the
    number of lanes reading them, and the (lanes, 12) int32 counter sets
    it writes, once each: three with ``track_ab``, else one) and its integer
    operations over the CUDA cores' peak (PEAK_FLOPS[torch.float32]; the
    card's int32 rate is no higher).  The operations are counted from the
    data and leave out what depends on the outcome (spills, fills,
    victims), so they are a lower bound: per lane, ENGINE_OPS_PER_REG for
    each active REG access where the lane's cVRF has fewer than 32 slots,
    ENGINE_OPS_PER_WAY for each way of each active MEM access, and a
    multiply and an add per counter, counter set and row walked."""
    capacity = np.asarray(cfg[0])
    lanes = x.shape[0] * len(capacity) * machines
    rows = torch.as_tensor(kw["lengths"], device=x.device)
    sets = 3 if kw["track_ab"] else 1
    nbytes = (int(rows.sum()) * es.NCOL * x.element_size()
              + sets * lanes * es.NUM_COUNTERS * 4)
    walked = torch.arange(x.shape[1], device=x.device)[None] < rows[:, None]
    reg = int(((x[..., es.RV:es.RV + 3] != 0).sum(-1) * walked).sum())
    mem = int(((x[..., es.MV:es.MV + 2] != 0).sum(-1) * walked).sum())
    ops = machines * (
        int((capacity < isa.NUM_ARCH_VREGS).sum()) * ENGINE_OPS_PER_REG * reg
        + len(capacity) * (ENGINE_OPS_PER_WAY * kw["l1_ways"] * mem
                           + 2 * 12 * sets * int(rows.sum())))
    return bound_ms(nbytes, ops, torch.float32)


def _groups(x, cfg, kw):
    """engine_scan_plan's launch groups for K1's inputs."""
    return es.engine_scan_plan(kw["l1_sets"], kw["l1_ways"], kw["lengths"],
                               cfg, T=x.shape[1])["groups"]


def _reg_inputs(group, cfg):
    """A group's K1a lanes: their programs and configs."""
    prog, k = map(list, zip(*group["reg_lanes"]))
    return prog, tuple(np.asarray(a)[k] for a in cfg)


def _l1_lanes(group):
    """A group's K1b lanes (program, K1a lane) and outputs' K1b lanes."""
    prog, _, reg = map(list, zip(*group["l1_lanes"]))
    return prog, reg, [j for _, _, j in group["outputs"]]


def _no_stream(x):
    return (torch.empty((0, x.shape[1], es.REG_SITES), dtype=torch.int8,
                        device=x.device),
            torch.zeros((0, es.NUM_SETS, len(es.REG_COUNTERS)),
                        dtype=torch.int32, device=x.device))


def _max_diff(got, want) -> int:
    return int((got.cpu().long() - want.cpu().long()).abs().max()) if (
        want.numel()) else 0


def check_split_halves(label, x_cpu, spill0s, cfg, mach, kw) -> dict:
    """K1a against engine_reg_plain and K1b against engine_l1_plain on
    their own inputs (K1b given the plain K1a's stream and counters) in
    every launch group: the stream within each lane's rows and all
    counters, bitwise.  Returns the largest |kernel - plain| of each, the
    plain versions' host ms and the kernels' device ms."""
    lengths = kw["lengths"]
    x = x_cpu.cuda()
    out = dict(reg_err=0, l1_err=0, reg_plain_ms=0.0, l1_plain_ms=0.0,
               reg_ms=0.0, l1_ms=0.0, reg_lanes=0, l1_lanes=0)
    for g in _groups(x_cpu, cfg, kw):
        stream, ctr = _no_stream(x_cpu)
        if g["reg_lanes"]:
            prog, rcfg = _reg_inputs(g, cfg)
            t0 = time.perf_counter()
            stream, ctr = es.engine_reg_plain(
                x_cpu, prog, rcfg, track_ab=kw["track_ab"], lengths=lengths)
            out["reg_plain_ms"] += (time.perf_counter() - t0) * 1e3
            call = lambda: es.engine_reg_cuda(  # noqa: E731
                x, prog, rcfg, track_ab=kw["track_ab"], lengths=lengths)
            got_s, got_c = call()
            torch.cuda.synchronize()
            err = _max_diff(got_c, ctr)
            for r, p in enumerate(prog):
                err = max(err, _max_diff(got_s[r, :lengths[p]],
                                         stream[r, :lengths[p]]))
            check(err == 0, f"engine {label}: K1a differs from "
                  f"engine_reg_plain by up to {err}")
            out["reg_ms"] += cuda_ms(call, warmup=1, iters=ENGINE_ITERS)
            out["reg_lanes"] += len(prog)
        l1_prog, l1_reg, out_l1 = _l1_lanes(g)
        t0 = time.perf_counter()
        want = es.engine_l1_plain(x_cpu, spill0s, stream, ctr, l1_prog,
                                  l1_reg, out_l1, mach, **kw)
        out["l1_plain_ms"] += (time.perf_counter() - t0) * 1e3
        s_dev, c_dev = stream.cuda(), ctr.cuda()
        call = lambda: es.engine_l1_cuda(  # noqa: E731
            x, spill0s, s_dev, c_dev, l1_prog, l1_reg, out_l1, mach, **kw)
        got = call()
        torch.cuda.synchronize()
        err = max(_max_diff(a, b) for a, b in zip(got, want))
        check(err == 0, f"engine {label}: K1b differs from engine_l1_plain "
              f"by up to {err}")
        out["l1_ms"] += cuda_ms(call, warmup=1, iters=ENGINE_ITERS)
        out["l1_lanes"] += len(l1_prog)
    log("engine", check=f"{label}_halves", equal=True, **out)
    return out


def check_engine_twin(label, preps, sweep, machines, depth=None) -> dict:
    """K1 (K1a then K1b, engine_scan_cuda) against the one-walk plain twin
    on the same inputs: total, period A and period B counters, all 12,
    bitwise; then each kernel against its own plain version
    (check_split_halves).  K1's device time (CUDA events) and the twin's
    host time on those inputs.  ``depth`` cuts each trace to its first
    rows (the twin walks about a thousand rows a second)."""
    if depth is not None:
        preps = [simulator._slice_prep(p, min(p.num_rows, depth))
                 for p in preps]
    x_cpu, spill0s, cfg, mach, kw = _engine_inputs(preps, sweep, machines)
    t0 = time.perf_counter()
    want = es.engine_scan_plain(x_cpu, spill0s, cfg, mach, **kw)
    plain_ms = (time.perf_counter() - t0) * 1e3
    x = x_cpu.cuda()
    got = es.engine_scan_cuda(x, spill0s, cfg, mach, **kw)
    torch.cuda.synchronize()
    lanes = len(preps) * len(sweep) * len(machines)
    err = 0
    for g, w, name in zip(got, want, ("ctr", "ctr_a", "ctr_b")):
        diff = (g.cpu().long() - w.long()).abs()
        err = max(err, int(diff.max()))
        check(int(diff.max()) == 0,
              f"engine {label}: K1 {name} differs from the twin at "
              f"{int((diff > 0).sum())} counters")
    ms = cuda_ms(lambda: es.engine_scan_cuda(x, spill0s, cfg, mach, **kw),
                 warmup=1, iters=ENGINE_ITERS)
    out = dict(programs=len(preps), rows=[p.num_rows for p in preps],
               lanes=lanes, max_abs_err=err, ms=ms, plain_host_ms=plain_ms,
               **dict(zip(("bound_ms", "bound_by"), engine_bound_ms(
                   x, cfg, kw, len(machines)))))
    log("engine", check=label, equal=True, **out)
    halves = check_split_halves(label, x_cpu, spill0s, cfg, mach, kw)
    return dict(out, **halves)


def phase_engine_twin() -> dict:
    """K1 against its twin, and K1a and K1b against their plain versions,
    at reduced size: every rvv program unfolded and folded on
    CONF_POINTS' configs x (their machines + M6), and the hazard lanes on
    the smallest programs.  Returns the unfolded check's figures (the
    kernels line's plain times) with the largest |kernel - plain| of the
    three checks, per kernel."""
    built = {n: b.build(**b.reduced_params).program
             for n, b in rvv.BENCHMARKS.items()}
    sweep = simulator.SweepConfig(
        np.asarray([c for c, _, _ in CONF_POINTS], np.int32),
        np.asarray([p for _, p, _ in CONF_POINTS], np.int32),
        np.zeros(len(CONF_POINTS), bool))
    machines = simulator.MachineSweep.from_params(
        [m for _, _, m in CONF_POINTS]
        + [M6.point(i) for i in range(len(M6))])
    unfolded = check_engine_twin(
        "reduced_unfolded", [simulator.prepare(p) for p in built.values()],
        sweep, machines)
    folded = [simulator.prepare(p, fold=True,
                                warm_lines=FOLD_CHECK_WARM_LINES)
              for p in built.values()]
    check(sum(p.num_folds > 0 for p in folded) == len(folded) - 1,
          "engine: the folded check's traces did not fold (all but "
          "pathfinder's 133 rows should)")
    checks = [unfolded,
              check_engine_twin("reduced_folded", folded, sweep, machines),
              check_engine_twin(
                  "hazards",
                  [simulator.prepare(built[n]) for n in HAZARD_PROGRAMS],
                  HAZARD_SWEEP, simulator.MachineSweep.from_params(
                      [simulator.DEFAULT_MACHINE]))]
    return dict(unfolded, **{k: max(c[k] for c in checks)
                             for k in ("max_abs_err", "reg_err", "l1_err")})


def _walked(x, lengths):
    """(P, T) mask of the rows each program walks."""
    rows = torch.as_tensor(lengths, device=x.device)
    return torch.arange(x.shape[1], device=x.device)[None] < rows[:, None]


def reg_bound_ms(x, kw, prog) -> tuple[float, str]:
    """Least time for K1a's work over its lanes ``prog``: the rows of each
    program read once, the stream of each lane's rows and its counter
    sets written once; ENGINE_OPS_PER_REG operations for each active REG
    access of each lane and a multiply and an add per REG counter,
    counter set and row."""
    lengths, sets = kw["lengths"], 3 if kw["track_ab"] else 1
    rows = sum(lengths[p] for p in set(prog))
    lane_rows = sum(lengths[p] for p in prog)
    nbytes = (rows * es.NCOL * x.element_size() + lane_rows * es.REG_SITES
              + len(prog) * es.NUM_SETS * len(es.REG_COUNTERS) * 4)
    reg = ((x[..., es.RV:es.RV + 3] != 0).sum(-1)
           * _walked(x, lengths)).sum(-1).tolist()
    ops = sum(ENGINE_OPS_PER_REG * reg[p] for p in prog) + (
        2 * len(es.REG_COUNTERS) * sets * lane_rows)
    return bound_ms(nbytes, ops, torch.float32)


def l1_bound_ms(x, kw, group, accesses: int, machines: int
                ) -> tuple[float, str]:
    """Least time for K1b's work on a launch group: the rows of each
    program and K1a's stream read once, the outputs' counter sets written
    once; ENGINE_OPS_PER_WAY operations on each way for each of the
    ``accesses`` (counted from the data) and a multiply and an add per
    counter, counter set and output."""
    lengths, sets = kw["lengths"], 3 if kw["track_ab"] else 1
    rows = sum(lengths[p] for p in {p for p, _, _ in group["l1_lanes"]})
    stream = sum(lengths[p] for p, _ in group["reg_lanes"]) * es.REG_SITES
    outputs = len(group["outputs"]) * machines
    nbytes = (rows * es.NCOL * x.element_size() + stream
              + sets * outputs * es.NUM_COUNTERS * 4)
    ops = (ENGINE_OPS_PER_WAY * kw["l1_ways"] * accesses
           + 2 * es.NUM_COUNTERS * sets * outputs)
    return bound_ms(nbytes, ops, torch.float32)


def bucket_sizes(x, spill0s, stream, group, kw) -> tuple[int, int]:
    """The accesses of a launch group's K1b lanes, and the most any one
    (lane, set) bucket holds (K1b's longest chain), counted on the card
    from the rows and K1a's stream."""
    total, largest = 0, 0
    for p, _, r in group["l1_lanes"]:
        rows = x[p, :kw["lengths"][p]]
        lines = [rows[:, es.ML:es.ML + 2][rows[:, es.MV:es.MV + 2] != 0]
                 .long()]
        if r >= 0:
            regs = stream[r, :kw["lengths"][p]].long()
            lines.append(es._wrap32(int(spill0s[p]) + regs[regs >= 0]))
        lines = torch.cat(lines)
        counts = torch.bincount(torch.remainder(lines, kw["l1_sets"]),
                                minlength=kw["l1_sets"])
        total += lines.numel()
        largest = max(largest, int(counts.max()))
    return total, largest


def time_engine(label, group_preps, sweep, machine) -> dict:
    """K1's device time on one of the paper path's inputs (CUDA events,
    the mean of ENGINE_ITERS calls after a warm-up): the whole call, K1a
    and K1b alone, each beside its bound and its longest chain counted
    from the data (the rows of the longest K1a lane, the accesses of the
    largest K1b bucket) with the ns per chain step."""
    t0 = time.perf_counter()
    x_cpu, spill0s, cfg, mach, kw = _engine_inputs(
        group_preps, sweep, simulator.MachineSweep.from_params([machine]))
    stack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = x_cpu.cuda()
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    del x_cpu
    ms = cuda_ms(lambda: es.engine_scan_cuda(x, spill0s, cfg, mach, **kw),
                 warmup=1, iters=ENGINE_ITERS)
    groups = _groups(x, cfg, kw)
    reg_ms = l1_ms = 0.0
    reg_lanes, longest, accesses, largest = [], 0, 0, 0
    reg_bound = l1_bound = (0.0, "bytes")
    for g in groups:
        stream, ctr = _no_stream(x)
        if g["reg_lanes"]:
            prog, rcfg = _reg_inputs(g, cfg)
            call = lambda: es.engine_reg_cuda(  # noqa: E731
                x, prog, rcfg, track_ab=kw["track_ab"],
                lengths=kw["lengths"])
            stream, ctr = call()
            reg_ms += cuda_ms(call, warmup=0, iters=ENGINE_ITERS)
            reg_lanes += prog
            longest = max(longest, max(kw["lengths"][p] for p in prog))
        n, big = bucket_sizes(x, spill0s, stream, g, kw)
        accesses += n
        largest = max(largest, big)
        l1_prog, l1_reg, out_l1 = _l1_lanes(g)
        l1_ms += cuda_ms(lambda: es.engine_l1_cuda(
            x, spill0s, stream, ctr, l1_prog, l1_reg, out_l1, mach, **kw),
            warmup=1, iters=ENGINE_ITERS)
        b = l1_bound_ms(x, kw, g, n, len(mach[0]))
        l1_bound = (l1_bound[0] + b[0], b[1])
    if reg_lanes:
        reg_bound = reg_bound_ms(x, kw, reg_lanes)
    rows = kw["lengths"]
    out = dict(
        programs=len(group_preps), rows=sum(rows), longest_rows=max(rows),
        configs=len(sweep), l1_sets=kw["l1_sets"], groups=len(groups),
        ms=ms, **dict(zip(("bound_ms", "bound_by"),
                          engine_bound_ms(x, cfg, kw, 1))),
        reg_lanes=len(reg_lanes), reg_ms=reg_ms, reg_bound_ms=reg_bound[0],
        reg_bound_by=reg_bound[1], reg_chain_rows=longest,
        reg_ns_per_chain_step=reg_ms * 1e6 / longest if longest else None,
        l1_ms=l1_ms, l1_bound_ms=l1_bound[0], l1_bound_by=l1_bound[1],
        l1_accesses=accesses, l1_chain_accesses=largest,
        l1_ns_per_chain_step=l1_ms * 1e6 / largest if largest else None,
        stack_pack_s=stack_s, host_to_device_s=copy_s)
    log("engine", timing=label, **out)
    return out


def _engine_grid(programs, names, sweep, machine, preps, fold=True):
    """simulate_grid on the card over the named paper-size programs,
    folded as the reference's Session folds them, then each program whose
    certificate failed at some grid point re-run unfolded if it has at
    most REFINE_MAX_ROWS rows.  ``preps`` caches the prepared traces by
    (name, fold, L1 geometry) and their host seconds."""
    def prep(name, fold):
        key = (name, fold, machine.l1_sets, machine.l1_ways)
        if key not in preps:
            t0 = time.perf_counter()
            preps[key] = (simulator.prepare(programs[name], fold=fold,
                                            machine=machine),
                          time.perf_counter() - t0)
        return preps[key][0]

    out = simulator.simulate_grid([prep(n, fold) for n in names], sweep,
                                  machine, batch_programs=True,
                                  device="cuda")
    refined = []
    for pi, name in enumerate(names):
        if ("fold_exact" not in out or out["fold_exact"][pi].all()
                or programs[name].num_instructions > REFINE_MAX_ROWS):
            continue
        sub = simulator.simulate_grid([prep(name, False)], sweep, machine,
                                      device="cuda")
        for k in out:
            out[k][pi] = sub[k][0] if k != "fold_exact" else True
        refined.append(name)
    return out, refined


ENGINE_KERNELS = {"engine_reg": es.engine_reg_cuda,
                  "engine_l1": es.engine_l1_cuda}


def phase_engine(programs) -> dict:
    """The engine's main path at paper size, through simulate_grid on the
    card (K1a and K1b): table3 folded (capacity 32, FIFO, 16 KB/2w) and
    the pareto grid (PARETO_CAPS x 4 and 16 KB) per the reference's
    fold/refine rule, held exactly to BENCH_core.json; then table3
    unfolded, reported beside the folded cycles (a difference is fault R1
    of the reference's fold certificate on a paper kernel, not a
    failure).  Each kernel must have launched in that run.  Then, outside
    the counted run, K1a and K1b against their plain versions on the main
    path's inputs cut in depth, and the device times of the folded table3
    grid, unfolded resnet50_l10 and the folded 4 KB pareto grid beside the
    host's prepare and _stack seconds."""
    bench = json.loads((ROOT / "BENCH_core.json").read_text())["kernels"]
    names = list(rvv.BENCHMARKS)
    preps = {}
    t3 = simulator.SweepConfig.make([isa.NUM_ARCH_VREGS])
    pareto_sweep = simulator.SweepConfig.make(PARETO_CAPS)
    for fn in ENGINE_KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    folded, t3_refined = _engine_grid(programs, names, t3,
                                      simulator.DEFAULT_MACHINE, preps)
    pareto = {}
    for kb in PARETO_L1_KB:
        pareto[kb] = _engine_grid(programs, names, pareto_sweep,
                                  _l1_machine(kb), preps)
    unfolded = {}
    for name in names:
        out, _ = _engine_grid(programs, [name], t3,
                              simulator.DEFAULT_MACHINE, preps, fold=False)
        unfolded[name] = int(out["cycles"][0, 0])
        if name != "resnet50_l10":
            preps.pop((name, False, 256, 2), None)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in ENGINE_KERNELS.items()}
    main_s = time.perf_counter() - t0
    log("engine", path="paper", seconds=round(main_s, 2),
        launches=launches)
    check(all(launches.values()), f"engine: a kernel of the main path "
          f"was never launched: {launches}")

    held = 0
    for pi, name in enumerate(names):
        got, want = int(folded["cycles"][pi, 0]), bench[name][
            "table3.vec_cycles"]
        log("engine", table3=name, T=programs[name].num_instructions,
            rows_folded=preps[(name, True, 256, 2)][0].num_rows,
            cycles=got, want=want, refined=name in t3_refined,
            fold_exact=bool(folded["fold_exact"][pi, 0]),
            unfolded_cycles=unfolded[name],
            unfolded_minus_folded=unfolded[name] - got)
        check(got == want, f"engine table3 {name}: {got} cycles, "
              f"BENCH_core.json {want}")
        held += 1
    for kb, (out, refined) in pareto.items():
        for pi, name in enumerate(names):
            for ci, cap in enumerate(PARETO_CAPS):
                key = f"pareto_cap{cap}_l1{kb}.cycles"
                if key not in bench[name]:
                    continue
                got = int(out["cycles"][pi, ci])
                check(got == bench[name][key], f"engine {name} {key}: "
                      f"{got}, BENCH_core.json {bench[name][key]}")
                held += 1
        log("engine", pareto_l1_kb=kb, refined=refined, equal=True)
    log("engine", held_to_bench=held, equal=True)

    # Outside the counted run: K1, K1a and K1b against their plain
    # versions on the main path's own inputs (its lanes, L1 geometries
    # and folded rows), cut in depth.
    checks = []
    for label, kb, sweep in (("table3_folded", 16, t3),
                             ("pareto_4kb", 4, pareto_sweep)):
        m = _l1_machine(kb)
        checks.append(check_engine_twin(
            f"{label}_first_{ENGINE_CHECK_ROWS}_rows",
            [preps[(n, True, m.l1_sets, m.l1_ways)][0] for n in names],
            sweep, simulator.MachineSweep.from_params([m]),
            depth=ENGINE_CHECK_ROWS))

    # Timing, outside the counted run.
    timing = {}
    m4 = _l1_machine(4)
    for label, keys, sweep, machine in (
            ("table3_folded", [(n, True, 256, 2) for n in names], t3,
             simulator.DEFAULT_MACHINE),
            ("resnet50_l10_unfolded", [("resnet50_l10", False, 256, 2)], t3,
             simulator.DEFAULT_MACHINE),
            ("pareto_4kb_folded", [(n, True, m4.l1_sets, m4.l1_ways)
                                   for n in names], pareto_sweep, m4)):
        timing[label] = dict(
            time_engine(label, [preps[k][0] for k in keys], sweep, machine),
            prepare_s=sum(preps[k][1] for k in keys))
    return dict(launches=launches, held=held, timing=timing,
                main_path_s=main_s,
                **{k: max(c[k] for c in checks)
                   for k in ("max_abs_err", "reg_err", "l1_err")})


# ----------------------------------------------------------------- prefill --

def _prompt_batch(cfg, b, s, device, seed=0):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    pos = torch.arange(s).expand(b, s)
    return {"tokens": toks.to(device), "positions": pos.to(device)}


def _prefill(model, impl, batch):
    model.cfg = dataclasses.replace(model.cfg, attn_impl=impl)
    out = model.prefill(batch)
    torch.cuda.synchronize()
    return out


def phase_prefill(model) -> int:
    """Full-width prefill through the flash kernel, held against the sdpa
    path; returns the kernel launches it made."""
    cfg = model.cfg
    batch = _prompt_batch(cfg, PREFILL_BATCH, PREFILL_LEN, "cuda")
    fa.flash_attention_cuda.launches = 0
    t0 = time.perf_counter()
    flash = _prefill(model, "flash", batch)
    t_flash = time.perf_counter() - t0
    launches = fa.flash_attention_cuda.launches
    launches_tc = fa.flash_attention_cuda.launches_tc
    t0 = time.perf_counter()
    sdpa = _prefill(model, "sdpa", batch)
    t_sdpa = time.perf_counter() - t0
    check(flash.shape == (PREFILL_BATCH, PREFILL_LEN, cfg.vocab_size),
          f"prefill logits shape {tuple(flash.shape)}")
    check(bool(torch.isfinite(flash).all()), "non-finite prefill logits")
    dlogit = float((flash.float() - sdpa.float()).abs().max())
    top1 = float((flash.argmax(-1) == sdpa.argmax(-1)).float().mean())
    log("prefill", arch=cfg.name, layers=cfg.num_layers, d=cfg.d_model,
        heads=cfg.num_heads, head_dim=cfg.head_dim, vocab=cfg.vocab_size,
        dtype=cfg.dtype, tokens=f"{PREFILL_BATCH}x{PREFILL_LEN}",
        flash_launches=launches, flash_launches_tc=launches_tc,
        max_abs_dlogit_vs_sdpa=dlogit,
        top1_agreement_vs_sdpa=top1, first_call_s_flash=round(t_flash, 3),
        first_call_s_sdpa=round(t_sdpa, 3))
    check(launches == launches_tc == cfg.num_layers,
          f"{launches} flash launches ({launches_tc} on the tensor cores), "
          f"want one per layer ({cfg.num_layers}), all on the tensor cores")
    # Random weights give near-tied logits, and the two paths round the
    # bf16 attention output at other places through 32 layers, so only a
    # loose agreement is expected here; the tight check is the f32 one
    # below.
    check(top1 >= 0.9 and dlogit <= 0.5,
          f"flash vs sdpa prefill: top-1 {top1}, max |dlogit| {dlogit}")

    # Small input, tight tolerance: a reduced f32 model on the card
    # through the kernel vs the same weights on the CPU through the plain
    # twin.
    small = dataclasses.replace(cfg.reduced(), dtype="float32",
                                attn_impl="flash")
    m_gpu = Model(small, device="cuda")
    m_gpu.init(torch.Generator(device="cuda").manual_seed(2))
    m_cpu = Model(small, device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in
                           m_gpu.state_dict().items()})
    sb = _prompt_batch(small, 2, 128, "cpu", seed=3)
    got = m_gpu.prefill({k: v.cuda() for k, v in sb.items()}).cpu()
    want = m_cpu.prefill(sb)
    err = float((got - want).abs().max())
    log("prefill", check="reduced_f32_card_vs_cpu", max_abs_err=err,
        tol=1e-3)
    check(err <= 1e-3, f"reduced prefill on the card off by {err}")
    return launches


# ------------------------------------------------------------------- serve --

def phase_serve(model) -> None:
    cfg = model.cfg
    scen = generate(dataclasses.replace(
        TRAFFIC_MIXES["steady"], n_requests=8, vocab=cfg.vocab_size,
        max_len=48), seed=0)
    engine = ServeEngine(cfg, model, slots=4, max_len=64, page_size=16,
                         kv_mode="dispersed", device="cuda")
    fa.flash_attention_cuda.launches = 0
    t0 = time.perf_counter()
    reqs = engine.serve(scen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in reqs)
    st = engine.kv_stats()
    log("serve", requests=len(reqs), done=sum(r.status == "done"
                                              for r in reqs),
        steps=len(engine.step_log), tokens_out=tokens,
        prompt_tokens=sum(len(r.prompt) for r in reqs),
        wall_s=round(wall, 3), tokens_per_s=round(tokens / wall, 2),
        hits=st["hits"], misses=st["misses"], fills=st["fills"],
        spills=st["spills"], hot_pages=st["hot_pages"],
        flash_launches=fa.flash_attention_cuda.launches)
    check(all(r.status == "done" for r in reqs),
          f"statuses {[r.status for r in reqs]}")


# ---------------------------------------------------------------- roofline --

# The reference's measured grid (benchmarks/roofline.py): 2 GEMM cases x
# W in {0, 1, 2, 4} x {f32, bf16, int8}, 1 attention case x 3
# precisions, and 3 equal-footprint points for each GEMM case.
REFERENCE_ROOFLINE_ROWS = 2 * 4 * 3 + 1 * 3 + 2 * 3
COUNTED = {"flash_attention": fa.flash_attention_cuda,
           "matmul_grouped": dg.matmul_grouped_cuda,
           "matmul_dispersed": dg.matmul_dispersed_cuda,
           "rmsnorm": rn.rmsnorm_cuda}


def reset_launches() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def read_launches() -> dict:
    """Each kernel's launches, and K6's by route (``rmsnorm_<route>``)."""
    torch.cuda.synchronize()
    out = {name: fn.launches for name, fn in COUNTED.items()}
    out.update({f"rmsnorm_{route}": n
                for route, n in rn.rmsnorm_cuda.by_route().items()})
    return out


def phase_roofline() -> dict:
    """The port's measured roofline on the card, then vmem_dispersion's
    spot check; returns the kernel launches of each path."""
    reset_launches()
    _, _, rows = roofline.run_measured(smoke=False, device="cuda")
    launches = read_launches()
    for r in rows:
        print("[roofline] " + json.dumps(r), flush=True)
    for study in roofline.json_extra()["equal_vmem"]:
        log("roofline", equal_vmem=study["case"],
            measured_winner=study["measured_winner"],
            model_winner=study["model_winner"])
    stats = roofline.perf_stats()
    log("roofline", rows=len(rows), want_rows=REFERENCE_ROOFLINE_ROWS,
        model_agree=sum(bool(r["model_agree"]) for r in rows),
        launches=json.dumps(launches), perf_stats=json.dumps(stats))
    check(len(rows) == REFERENCE_ROOFLINE_ROWS,
          f"roofline gave {len(rows)} rows, the reference grid has "
          f"{REFERENCE_ROOFLINE_ROWS}")
    check(all(r["model_agree"] for r in rows),
          "a roofline row's counted bytes disagree with the closed form")
    for name in ("flash_attention", "matmul_grouped", "matmul_dispersed"):
        check(launches[name] > 0, f"the roofline launched no {name}")
        check(stats["kernel_launches"][name] == launches[name],
              f"perf_stats disagrees on {name}")
    check(not any(stats["plain_calls"].values()),
          f"the roofline on the card ran plain twins: {stats}")
    # bf16 and int8 GEMM rows and the bf16 attention row on the tensor
    # cores, the others on the FMAs
    on_tc = {"gemm": ("bf16", "int8"), "flash_attention": ("bf16",)}
    for kernel, precs in stats["route_launches"].items():
        for prec, r in precs.items():
            want, other = (("tc", "fma") if prec in on_tc[kernel]
                           else ("fma", "tc"))
            check(r[want] > 0 and r[other] == 0,
                  f"roofline {prec} {kernel} rows by route: {r}")
    check(sorted(stats["route_launches"]["flash_attention"]) ==
          sorted(roofline.PRECISIONS), "roofline attention precisions")

    host_vs_device()

    reset_launches()
    vrows = vmem_dispersion.run("cuda")
    vlaunches = read_launches()
    spot = vrows[-1]
    log("vmem_dispersion", rows=len(vrows), spot_check=spot["name"],
        max_err=spot["max_err"], launches=json.dumps(vlaunches))
    check(spot["max_err"] <= 1e-3 and vlaunches["matmul_grouped"] == 1,
          f"vmem_dispersion spot check: {spot}, {vlaunches}")
    return {"roofline": launches, "vmem_dispersion": vlaunches}


def host_vs_device(calls: int = 20) -> None:
    """Where a roofline point's time goes, at the 512x512x256 f32 points
    W=0 (K4, 4 launches a call) and W=4 (K3), at the attention point in
    bf16 (tensor-core route) and f32 (CUDA-core route), and for K6 and
    F.rms_norm at (NORM_ROWS, NORM_D) and (2048, 3072) bf16: us per call
    timed by CUDA events around one call from an idle stream (host work
    inside the window), around ``calls`` back-to-back calls (the
    roofline's timing: the device's time unless the host is slower),
    around ``calls`` calls queued behind a sleep kernel (the device's
    time alone: the host issues them all before the first one runs), and
    the host's own time to issue one call (perf_counter over ``calls``
    calls with no synchronisation)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    a = randn(gen, (512, 512), torch.float32)
    b = randn(gen, (512, 256), torch.float32)
    kw = dict(block_m=roofline.BLOCK_M, block_k=roofline.BLOCK_K)
    (attn_case, shape), = roofline.FLASH_CASES.items()
    qkv = {dtype: _qkv(gen, shape, shape, dtype)
           for dtype in (torch.bfloat16, torch.float32)}
    fb = dict(block_q=roofline.FLASH_BLOCK, block_k=roofline.FLASH_BLOCK)
    points = [
        (dict(host_vs_device="gemm_512x512x256_f32", working_set=0),
         lambda: ops.matmul_dispersed(a, b, **kw)),
        (dict(host_vs_device="gemm_512x512x256_f32", working_set=4),
         lambda: ops.matmul(a, b, working_set=4, **kw))]
    points += [(dict(host_vs_device=f"{attn_case}_{str(dtype)[6:]}",
                     route=fa.flash_plan(*qkv[dtype])["route"]),
                lambda t=qkv[dtype]: ops.flash_attention(*t, **fb))
               for dtype in qkv]
    # K6 and F.rms_norm at the kernel table's shape and the prefill's
    for rows, d in ((NORM_ROWS, NORM_D), (2048, 3072)):
        x = randn(gen, (rows, d), torch.bfloat16)
        scale = (1.0 + 0.1 * randn(gen, (d,), torch.float32)).to(x.dtype)
        shape = f"{rows}x{d}_bf16"
        points += [
            (dict(host_vs_device=f"rmsnorm_{shape}",
                  route=rn.rmsnorm_plan(x)["route"]),
             lambda x=x, s=scale.float(): rn.rmsnorm(x, s)),
            (dict(host_vs_device=f"rms_norm_{shape}"),
             lambda x=x, s=scale, d=d: torch.nn.functional.rms_norm(
                 x, (d,), weight=s, eps=1e-6))]
    for label, fn in points:
        fn()
        torch.cuda.synchronize()
        one = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            one.append(start.elapsed_time(end) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_us = (time.perf_counter() - t0) * 1e6 / calls
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        check(host_us * calls < 1e6 * QUEUE_SLEEP_CYCLES / 2e9,
              "the sleep kernel ended before the calls were queued")
        log("roofline", **label, one_call_us=sorted(one)[2],
            back_to_back_us=cuda_ms(fn, warmup=1, iters=calls) * 1e3,
            queued_device_us=start.elapsed_time(end) * 1e3 / calls,
            host_issue_us=host_us)


# ------------------------------------------------------------------ timing --

def check_tc_plan() -> None:
    """dispersed_gemm.tc_plan's tile against the built kernel's
    (gemm_tc_tile) at each block_m, with and without K4's f32 C tile in
    shared memory (the same for bf16 and int8).  The log gives the
    kernel's dynamic shared memory, which ptxas does not report."""
    for bm in dg.TC_BLOCK_M:
        plan = dg.tc_plan(1024, 256, 1024, block_m=bm, block_k=512,
                          working_set=0, dtype=torch.bfloat16)
        for fill in (False, True):
            pre = "fill_" if fill else ""
            want = dict(n_tile=plan["n_tile"], stages=plan[pre + "stages"],
                        smem_bytes=plan[pre + "smem_bytes"])
            built = dg.built_tc_tile(bm, fill)
            log("build", gemm_tc_tile=f"block_m={bm}", fill=fill,
                **built, tc_plan_agrees=built == want)
            check(built == want, f"tc_plan {want} != the built kernel's "
                                 f"{built} at block_m={bm}, fill={fill}")


def check_flash_plan() -> None:
    """flash_attention.flash_plan's tile against the built flash_tc's
    (flash_tc_tile) at every head dim."""
    for d in fa.HEAD_DIMS:
        q = torch.empty((1, 1, 128, d), dtype=torch.bfloat16, device="cuda")
        plan = fa.flash_plan(q, q, q)
        want = {key: plan[key] for key in ("block_q", "block_k", "stages",
                                           "smem_bytes")}
        built = fa.built_tc_tile(d)
        log("build", flash_tc_tile=f"d={d}", **built, swizzle=plan[
            "swizzle"], flash_plan_agrees=built == want)
        check(built == want, f"flash_plan {want} != the built kernel's "
                             f"{built} at d={d}")


def ptxas_summary(text: str, kernel: str) -> list[dict]:
    """Registers and spill bytes of each entry function of ``kernel`` in
    a ``-Xptxas -v`` log."""
    out, cur = [], None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            cur = dict(function=name) if kernel in name else None
            if cur:
                out.append(cur)
        elif cur is not None and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            cur.update(stack=nums[0], spill_stores=nums[1],
                       spill_loads=nums[2])
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(line.split("Used")[1].split()[0])
    return out


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """The larger of bytes over the HBM rate and flops over the dtype's
    peak, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def phase_timing() -> dict:
    """K5 at the prefill shape beside its bound, its plain twin and
    scaled_dot_product_attention.  The card slows under sustained load,
    so K5 and SDPA are timed in FLASH_ROUNDS rounds, the order reversed
    every other round, and each time is the median of its rounds."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    shape = (PREFILL_BATCH, 32, PREFILL_LEN, 96)
    q, k, v = _qkv(gen, shape, shape, torch.bfloat16, bshd=True)
    fns = {"flash_attention": lambda: ops.flash_attention(q, k, v,
                                                          causal=True),
           "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
               q, k, v, is_causal=True)}
    samples = {name: [] for name in fns}
    c = fa.flash_attention_cuda
    tc0, fma0 = c.launches_tc, c.launches_fma
    for r in range(FLASH_ROUNDS):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            samples[name].append(cuda_ms(fns[name]))
    calls = FLASH_ROUNDS * (3 + 20)
    tc, fma = (c.launches_tc - tc0) / calls, (c.launches_fma - fma0) / calls
    check(tc == 1 and fma == 0,
          f"flash_attention at the prefill shape: {tc} tc, {fma} fma "
          f"launches per call")
    ms = statistics.median(samples["flash_attention"])
    lib_ms = statistics.median(samples["sdpa"])
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                        causal=True))
    bms, bound_by = attention_bound_ms(q, k, v, causal=True)
    log("timing", kernel="flash_attention", shape=list(shape),
        dtype="bfloat16", causal=True, route="tc", ms=ms,
        samples_ms=samples["flash_attention"], plain_ms=plain_ms,
        sdpa_ms=lib_ms, sdpa_samples_ms=samples["sdpa"], vs_sdpa=ms / lib_ms,
        bound_ms=bms, bound_by=bound_by, share_of_bound=bms / ms)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bms, bound_by=bound_by)


def phase_gemm_timing() -> dict:
    """K3 (W = 1, 4) and K4 at granite-8b's MLP GEMM: held against the
    plain twin in bf16; K3 bitwise equal across W and K4 bitwise equal to
    K3 in bf16 and int8; then, in bf16, each timed beside the bound, its
    schedule's bound, the plain twin and torch.matmul, with its launches
    per call by route."""
    m, k, n = GEMM_M, GEMM_K, GEMM_N
    kw = dict(block_m=GEMM_BLOCK_M, block_k=GEMM_BLOCK_K)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for dtype in (torch.int8, torch.bfloat16):
        a = randn(gen, (m, k), dtype)
        b = randn(gen, (k, n), dtype)
        got1 = ops.matmul(a, b, working_set=1, **kw)
        got4 = ops.matmul(a, b, working_set=4, **kw)
        gotd = ops.matmul_dispersed(a, b, **kw)
        torch.cuda.synchronize()
        same_w, same_d = torch.equal(got1, got4), torch.equal(got1, gotd)
        log("timing", check="gemm_bitwise", mkn=[m, k, n],
            dtype=str(dtype).split(".")[-1], grouped_w1_equals_w4=same_w,
            dispersed_equals_grouped=same_d)
        check(same_w, f"matmul_grouped W=1 and W=4 differ in {dtype}")
        check(same_d, f"matmul_dispersed != matmul_grouped in {dtype}")
        del got4, gotd
    want = dg.matmul_grouped_plain(a, b, working_set=1, **kw)
    atol, rtol = GEMM_TOL[torch.bfloat16]
    ok1, err1 = _close(got1, want, atol, rtol)
    del got1, want
    log("timing", check="gemm_vs_plain", mkn=[m, k, n], dtype="bfloat16",
        grouped_err=err1, atol=atol, rtol=rtol)
    check(ok1, f"GEMM vs plain twin at {m}x{k}x{n}: {err1}")

    iters = 10
    plain_ms = cuda_ms(lambda: dg.matmul_grouped_plain(
        a, b, working_set=1, **kw), warmup=1, iters=iters)
    lib_ms = cuda_ms(lambda: torch.matmul(a, b), iters=iters)
    flops = 2.0 * m * n * k
    bms, bound_by = bound_ms((m * k + k * n + m * n) * 2, flops,
                             torch.bfloat16)
    kernels = (("matmul_grouped_W1", 1), ("matmul_grouped", 4),
               ("matmul_dispersed", 0))
    fns = {name: (lambda w=w: ops.matmul(a, b, working_set=w, **kw)) if w
           else (lambda: ops.matmul_dispersed(a, b, **kw))
           for name, w in kernels}
    counts = {name: dg.matmul_grouped_cuda if w else
              dg.matmul_dispersed_cuda for name, w in kernels}
    # The card slows as it heats under back-to-back GEMMs: one run that
    # timed W=4 right after W=1 read W=4 10 % slower, the next, in turns,
    # 1 % faster.  So the three are timed in GEMM_ROUNDS rounds, the order
    # reversed every other round; each time is the median of its rounds,
    # and W=4 / W=1 is given per round and as the median.
    samples = {name: [] for name in fns}
    routes = {name: [0, 0] for name in fns}   # tc, fma launches
    for r in range(GEMM_ROUNDS):
        for name, _ in kernels if r % 2 == 0 else kernels[::-1]:
            c = counts[name]
            tc0, fma0 = c.launches_tc, c.launches_fma
            samples[name].append(cuda_ms(fns[name], warmup=1, iters=iters))
            routes[name][0] += c.launches_tc - tc0
            routes[name][1] += c.launches_fma - fma0
    ratios = [w4 / w1 for w4, w1 in zip(samples["matmul_grouped"],
                                        samples["matmul_grouped_W1"])]
    log("timing", check="grouped_W4_over_W1", mkn=[m, k, n],
        dtype="bfloat16", per_round=ratios,
        median=statistics.median(ratios), limit=1.10)
    out = {}
    for name, w in kernels:
        model = dg.hbm_traffic_model(m, n, k, working_set=max(w, 1),
                                     bytes_per_el=2, **kw)
        sched = model["grouped"] if w else model["dispersed"]
        sched_ms, sched_by = bound_ms(sched, flops, torch.bfloat16)
        ms = statistics.median(samples[name])
        calls = GEMM_ROUNDS * (1 + iters)
        tc, fma = (x / calls for x in routes[name])
        per_call = tc + fma
        check(tc > 0 and fma == 0,
              f"{name} in bf16 left the tensor-core route: {tc}, {fma}")
        log("timing", kernel=name, mkn=[m, k, n], dtype="bfloat16",
            working_set=w, ms=ms, samples_ms=samples[name], iters=iters,
            launches_per_call=per_call,
            launches_tc_per_call=tc, launches_fma_per_call=fma,
            plain_ms=plain_ms, matmul_ms=lib_ms, bound_ms=bms,
            bound_by=bound_by, share_of_bound=bms / ms,
            schedule_bytes=sched, schedule_bound_ms=sched_ms,
            schedule_bound_by=sched_by, share_of_schedule_bound=sched_ms / ms,
            vs_matmul=ms / lib_ms)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bms, bound_by=bound_by,
                         schedule_bound_ms=sched_ms,
                         launches_per_call=per_call, max_abs_err=err1)
    return out


def _norm_bound(x) -> tuple[float, str]:
    """K6's least time on x: x read and y written once (plus the f32
    scale) over HBM, or 4 flops an element over the f32 peak."""
    return bound_ms(2 * x.numel() * x.element_size() + x.shape[-1] * 4,
                    4.0 * x.numel(), torch.float32)


def phase_norm_timing() -> dict:
    """K6 beside its bound, plain twin and F.rms_norm (given the same
    scale, in bf16 exactly representable): at (NORM_ROWS, NORM_D) bf16,
    where the kernels line reports it, and at the prefill's norm shape
    (2048, 3072) bf16 and at (NORM_ROWS, NORM_D) f32.  The card's clocks
    drift under load, so K6 and F.rms_norm are timed in NORM_ROUNDS
    rounds, the order reversed every other round, and each time is the
    median of its rounds."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    fn = rn.rmsnorm_cuda
    out = {}
    for rows, d, dtype in ((NORM_ROWS, NORM_D, torch.bfloat16),
                           (2048, 3072, torch.bfloat16),
                           (NORM_ROWS, NORM_D, torch.float32)):
        x = randn(gen, (rows, d), dtype)
        scale = (1.0 + 0.1 * randn(gen, (d,), torch.float32)).to(dtype)
        scale32 = scale.float()
        atol, rtol = NORM_TOL[dtype]
        ok, err = _close(rn.rmsnorm(x, scale32),
                         rn.rmsnorm_plain(x, scale32), atol, rtol)
        check(ok, f"rmsnorm vs plain twin at ({rows}, {d}) {dtype}: {err}")
        fns = {"rmsnorm": lambda: rn.rmsnorm(x, scale32),
               "rms_norm": lambda: torch.nn.functional.rms_norm(
                   x, (d,), weight=scale, eps=1e-6)}
        samples = {name: [] for name in fns}
        before = fn.by_route()
        for r in range(NORM_ROUNDS):
            for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                samples[name].append(cuda_ms(fns[name], iters=NORM_ITERS))
        calls = NORM_ROUNDS * (3 + NORM_ITERS)
        per_call = {r: (n - before[r]) / calls
                    for r, n in fn.by_route().items()}
        route = rn.rmsnorm_plan(x)["route"]
        check(per_call[route] == 1 and sum(per_call.values()) == 1,
              f"rmsnorm at ({rows}, {d}) {dtype}: launches per call by "
              f"route {per_call}, want one on {route}")
        ms = statistics.median(samples["rmsnorm"])
        lib_ms = statistics.median(samples["rms_norm"])
        plain_ms = cuda_ms(lambda: rn.rmsnorm_plain(x, scale32))
        bms, bound_by = _norm_bound(x)
        dt = str(dtype).split(".")[-1]
        log("timing", kernel="rmsnorm", shape=[rows, d], dtype=dt,
            route=route, ms=ms, samples_ms=samples["rmsnorm"],
            launches_per_call=json.dumps(per_call), plain_ms=plain_ms,
            rms_norm_ms=lib_ms, rms_norm_samples_ms=samples["rms_norm"],
            vs_rms_norm=ms / lib_ms, bound_ms=bms, bound_by=bound_by,
            max_abs_err=err, share_of_bound=bms / ms)
        out[f"{rows}x{d}_{dt}"] = dict(ms=ms, plain_ms=plain_ms,
                                       library_ms=lib_ms, bound_ms=bms,
                                       bound_by=bound_by, max_abs_err=err)
    main = out.pop(f"{NORM_ROWS}x{NORM_D}_bfloat16")
    main["other_shapes"] = out
    return main


def engine_entry(name, part, at, engine, twin) -> dict:
    """The kernels line's record of K1a (``part`` "reg") or K1b ("l1"):
    its launches on the engine's paper path, the largest |kernel - plain|
    of its checks, its device time, bound and longest chain at the
    timing input ``at``, and every timing input's figures (with the whole
    K1 call's time and bound)."""
    t = engine["timing"][at]
    chain = dict(reg=("rows of the longest K1a lane", "reg_chain_rows"),
                 l1=("accesses of the largest K1b bucket",
                     "l1_chain_accesses"))[part]
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/engine_scan.cu",
        replaces="src/repro/core/simulator.py:386",
        launches=engine["launches"][name],
        launches_by_path={"engine": engine["launches"][name]},
        max_abs_err=max(engine[f"{part}_err"], twin[f"{part}_err"],
                        engine["max_abs_err"], twin["max_abs_err"]),
        timing_input=at, ms=t[f"{part}_ms"], bound_ms=t[f"{part}_bound_ms"],
        bound_by=t[f"{part}_bound_by"], chain=chain[0],
        chain_steps=t[chain[1]],
        ns_per_chain_step=t[f"{part}_ns_per_chain_step"],
        plain_ms=twin[f"{part}_plain_ms"], plain_device="cpu",
        plain_inputs=dict(programs=twin["programs"], rows=max(twin["rows"]),
                          lanes=twin[f"{part}_lanes"]),
        ms_at_plain_inputs=twin[f"{part}_ms"], library_ms=None,
        held_to_bench=engine["held"], timing=engine["timing"])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    logs = _build.build_all()
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "warning",
                                       "Performance Loss")):
                print(f"[build] {name}: {line.strip()}")
    log("build", kernels=sorted(logs), seconds=round(
        time.perf_counter() - t0, 2))
    for entry in ptxas_summary(logs["flash_attention"], "flash_tc"):
        log("build", **entry)
    for entry in ptxas_summary(logs["rmsnorm"], "rmsnorm_vec"):
        log("build", **entry)
    for entry in ptxas_summary(logs["engine_scan"], "engine_scan"):
        log("build", **entry)
    check_tc_plan()
    check_flash_plan()
    check_norm_plan()
    check_engine_plan()

    flash_err = phase_kernels()
    gemm_errs = phase_gemm_kernels()
    norm_err, norm_held = phase_norm_kernels()
    engine_twin = phase_engine_twin()
    programs = phase_trace()
    engine = phase_engine(programs)
    del programs

    cfg = get(ARCH)
    model = Model(cfg, device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(0))
    log("model", arch=cfg.name, params=sum(p.numel()
                                           for p in model.parameters()),
        weight_gb=round(sum(p.numel() * p.element_size()
                            for p in model.parameters()) / 1e9, 3))
    prefill_launches = phase_prefill(model)
    model.cfg = cfg
    phase_serve(model)
    del model
    torch.cuda.empty_cache()
    paths = phase_roofline()
    flash_timing = phase_timing()
    gemm = phase_gemm_timing()
    norm = phase_norm_timing()

    def launches(name, extra=None):
        by_path = {p: n[name] for p, n in paths.items() if n[name]}
        by_path.update(extra or {})
        return dict(launches=sum(by_path.values()), launches_by_path=by_path)

    route_launches = roofline.perf_stats()["route_launches"]
    flash_routes = {route: sum(r[route] for r in route_launches[
        "flash_attention"].values()) for route in ("tc", "fma")}
    flash_routes["tc"] += prefill_launches     # all on the tensor cores

    def gemm_entry(name, replaces):
        g = dict(gemm[name])
        err = max(g.pop("max_abs_err"), gemm_errs[name])
        return dict(name=name, route="cuda",
                    source="src/repro_torch/kernels/csrc/dispersed_gemm.cu",
                    replaces=replaces, **launches(name), max_abs_err=err,
                    shape=[GEMM_M, GEMM_K, GEMM_N], dtype="bfloat16",
                    roofline_launches_by_precision_and_route=route_launches[
                        "gemm"],
                    **g)

    k3 = gemm_entry("matmul_grouped",
                    "src/repro/kernels/dispersed_gemm.py:117")
    k3["working_set"] = 4
    k3["W1"] = {key: gemm["matmul_grouped_W1"][key] for key in
                ("ms", "bound_ms", "schedule_bound_ms", "launches_per_call")}
    norm_entry = dict(norm)
    norm_entry["max_abs_err"] = max(norm_entry["max_abs_err"], norm_err)
    norm_routes = {route: sum(n[f"rmsnorm_{route}"] for n in paths.values())
                   for route in rn.rmsnorm_cuda.routes}
    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:118",
             **launches("flash_attention", {"prefill": prefill_launches}),
             launches_by_route=flash_routes,
             roofline_launches_by_precision_and_route=route_launches[
                 "flash_attention"],
             max_abs_err=flash_err, shape=[PREFILL_BATCH, 32, PREFILL_LEN,
                                           96], dtype="bfloat16",
             **flash_timing),
        k3,
        gemm_entry("matmul_dispersed",
                   "src/repro/kernels/dispersed_gemm.py:164"),
        # K6 is on no path of the reference (only its test calls it), so
        # no path launches it; it is held (held_launches_by_route: the
        # kernel checks' launches) and timed above.
        dict(name="rmsnorm", route="cuda",
             source="src/repro_torch/kernels/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm.py:27",
             **launches("rmsnorm"), launches_by_route=norm_routes,
             held_launches_by_route=norm_held, shape=[NORM_ROWS, NORM_D],
             dtype="bfloat16", **norm_entry),
        # K1 is two kernels: K1a (the cVRF pass) at the main path's
        # largest K1a call, the folded 4 KB pareto grid, and K1b (the L1
        # pass) at its largest, unfolded resnet50_l10 (one lane, capacity
        # 32).  Their plain versions cannot walk paper-size traces, so
        # plain_ms is each on the host's CPU at the reduced check's inputs,
        # where the kernel's own time is ms_at_plain_inputs.
        engine_entry("engine_reg", "reg", "pareto_4kb_folded", engine,
                     engine_twin),
        engine_entry("engine_l1", "l1", "resnet50_l10_unfolded", engine,
                     engine_twin),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
