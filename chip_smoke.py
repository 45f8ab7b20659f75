"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

  1. build     compile every CUDA kernel of the port from src/ (nvcc,
               sm_90a), one nvcc per source, all started together, print
               flash_tc's, rmsnorm_vec's, K2's and the fused AdamW's
               registers and spills (AdamW's none), and hold
               dispersed_gemm.tc_plan, flash_attention.flash_plan,
               rmsnorm.rmsnorm_plan, engine_scan_plan, cluster_scan_plan
               and adamw.TILE against the built kernels' tiles;
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
     paper     the front door at paper size: repro_torch.benchmarks.run
               in this process over the nine paper suites (table3, fig2,
               fig4, fig5, fig6, fig8, pareto, policy_headroom,
               ablation_sensitivity) through the api.Session that [trace]
               and [engine] filled (K1 on the card), one suite at a time
               under torch.profiler: per suite its rows, wall, prepare and
               engine seconds, engine calls, K1a/K1b launches and K1's
               device ms; the report's kernel records held exactly to
               BENCH_core.json (table3, pareto, policy_headroom,
               ablation_sensitivity: 165 values, all present), its
               metrics (names, kinds) and macro_models blocks equal to
               BENCH_core.json's, fig4's pathfinder row at capacity 3 as
               the reference's own check; K1a and K1b launched and no
               plain engine function called; the report written to
               chiprun_out/paper_report.json;
     cluster   the cluster (P4) with K2, the cluster scan: K2 against the
               split's plain versions, bitwise (N = 1, 2, 4, 8 behind five
               shared memories, on the reduced programs and on the
               cluster suites' paper inputs cut to 2,048 rows), the N = 1
               passthrough against K1; then cluster_sweep and dse through
               repro_torch.benchmarks.run at paper size through the same
               Session, every numeric field of their 180 rows (1,692
               values) and their fronts and summaries held exactly to
               BENCH_core.json (plan-group provenance aside), per suite
               its wall, prepare and engine seconds, engine calls, K1a,
               K1b and K2 launches, K1's and K2's device ms and K2's
               largest bucket; K1a, K1b and K2 launched and no plain
               version of the engine run; K2 timed alone on
               cluster_sweep's 4 KB grid (per kernel, beside its bound
               and its longest chain);
     network   the bridge (P6): network_sweep through
               repro_torch.benchmarks.run uncut (five registry models
               lowered to 35 net:* tile programs, 5 capacities, 2 L1
               geometries: 350 points) through a new Session, K1 on the
               card: every field of its 50 rows but the wall clock held
               exactly to BENCH_core.json, with its networks, points and
               fold certificate; its wall, prepare and engine seconds,
               engine calls, K1a/K1b launches and K1's device ms;
  4. prefill   full-width phi3-mini-3.8b (random weights from a seeded
               generator): Model.prefill on 4 x 512 tokens with the flash
               kernel vs the plain sdpa path, counting kernel launches (all
               on the tensor-core route), and
               a reduced f32 model on the card vs the same on the CPU;
  5. serve     a ServeEngine with dispersed KV pages answers a seeded
               steady-traffic scenario at full width;
     moe       the MoE family at full width, each model freed before the
               next is built: deepseek-v2-lite-16b at full depth (MLA, one
               dense layer, 26 layers of 64 routed experts top-6 and 2
               shared) prefills 4 x 512 tokens (logits' shape, finite,
               aux loss finite and >= 0); phi3.5-moe-42b-a6.6b with its
               depth cut to 16 of 32 layers (memory) prefills 4 x 512
               through the flash kernel (D = 128, GQA 32/8), one launch
               per layer, all on the tensor cores, K5 held against sdpa
               layer by layer on the prefill's own inputs (the
               end-to-end comparison with sdpa, free-running and with
               the expert choices pinned, is reported: the experts'
               outputs dominate the residual, so it does not hold
               phase_prefill's bounds); for each model, a reduced f32
               copy on the card vs the same weights on the CPU (prefill
               and 8 decode steps), any token routed to another expert
               set a near-tie of its router;
     serve_moe full-width deepseek-v2-lite serves the seeded steady
               scenario with dispersed KV: its latent cache (c, kr)
               paged through the pool, every request done; one decode
               step's time alone and its device time;
     serving   kv_dispersion and serving_slo through
               repro_torch.benchmarks.run on the card: row counts,
               serving_slo's axes and Pareto fronts equal to
               BENCH_core.json's, kv_dispersion's rows equal to its pool
               on the CPU;
     families  P5b's last four families at their published widths and
               full depth, each built and freed before the next:
               qwen2-vl-7b (attention bias, M-RoPE, the vision stub over
               a 16 x 16 grid of its first 256 tokens), falcon-mamba-7b
               (Mamba, a torch loop over time), recurrentgemma-2b
               (RG-LRU and local attention) prefill 4 x 512 and
               whisper-large-v3 4 x 1,500 audio frames and 4 x 448
               tokens: shapes, finite logits, first and second call
               walls, peak memory, and the recurrences' device
               operations and ms per layer; qwen2-vl's prefill through
               K5 (D = 128, GQA 28/4), one launch per layer on the
               tensor cores, held against sdpa end to end (top-1 >= 0.9,
               max |dlogit| <= 0.5) and layer by layer; a reduced f32
               copy of each on the card vs the CPU (prefill and 8
               decode steps, the hybrid 12, past its window; qwen2-vl
               and whisper through K5; the SSM's and the hybrid's decode
               against their own prefill); each serves the seeded
               steady scenario cut to 8 requests (SSM and hybrid
               resident, qwen2-vl dispersed with k/v paged, whisper
               dispersed with seeded encoder K/V unpaged), with one
               decode step's wall and device time;
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
               same function;
     adamw     the optimizer's fused multi-tensor AdamW (two launches a
               step) on phi3-mini's full leaf set at full width (291
               leaves, 3.82 B parameters, bf16 parameters and gradients,
               f32 state, ~61 GB): each leaf's new m, v, master and
               parameter bitwise equal to the plain twin's given the
               kernels' clip scale, grad_norm within 1e-6 of the plain
               global norm, exactly two launches and one copy of the
               table a step (the wrapper's counters); the step timed
               (CUDA events, medians of
               ADAMW_ROUNDS rounds in turns with the plain twin) beside
               its 30-bytes-a-parameter bound;
  8. train     the training path (P7a): full-width phi3-mini-3.8b (bf16,
               seeded init, every earlier model freed) trained through
               Trainer for 3 steps of 4 x 256 tokens, microbatches 1,
               every optimizer step on the fused AdamW (counted):
               per step its loss (finite), grad norm, learning rate,
               wall, stream ms and peak memory (the first step's device
               ms and costliest device functions from torch.profiler),
               then tokens/s and the achieved TFLOP/s (6 N tokens over
               the later steps' wall); a checkpoint of params and
               optimizer
               state, at 16 of the 32 layers (full width: the full
               depth's 61.1 GB exceed the disk a run may write), saved
               and restored into a fresh Trainer, held leaf by leaf,
               which takes one more step; then a reduced f32 copy's step
               on the card against the same step on the CPU (loss and
               masters within 1e-4);
  9. shard     sharding (P7b) on a 1 x 1 ("data", "model") DeviceMesh
               over NCCL: full-width phi3-mini's prefill 4 x 512 through
               K5 on each rank's local shard (local_map, one launch per
               layer) held to the unsharded prefill, 8 greedy decode
               steps with the same tokens, one train step at full width
               and 8 of 32 layers with its loss and updated masters held
               to the unsharded step's (both optimizer steps on the fused
               AdamW, the sharded one on the local shards, counted);
               launch.dryrun's plan of that
               train step on the same mesh (meta tensors, a fake process
               group, in a process of its own) counting the real step's
               FlopCounterMode FLOPs exactly, its bytes per device beside
               max_memory_allocated and its FLOPs beside
               analytic.model_flops; then the production plan on the
               16 x 16 mesh for the 10 archs at train_4k and decode_32k,
               one [dryrun] line per cell.  Writes chiprun_out/shard.json.

The earlier phases run their models under torch.no_grad (the models'
parameters are trainable).  The last lines are the kernels' JSON record, the card's name and power
limit, and the result line {"ok": true, "device": {...}}.  Without a CUDA
device the script prints no result and exits 1.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import re
import shutil
import statistics
import subprocess
import os
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.benchmarks import (cluster_sweep, dse,  # noqa: E402
                                    kv_dispersion, roofline,
                                    vmem_dispersion)
from repro_torch.benchmarks import run as bench_run  # noqa: E402
from repro_torch.benchmarks.engine_timing import (  # noqa: E402
    KERNEL_NAMES, _k2_alone)
from repro_torch import api, rvv  # noqa: E402
from repro_torch.cluster import ClusterConfig  # noqa: E402
from repro_torch.cluster import engine as cluster_engine  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import (events, interpreter, isa, policies,  # noqa: E402
                              simulator)
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import adamw as fadamw  # noqa: E402
from repro_torch.kernels import cluster_scan as cs  # noqa: E402
from repro_torch.kernels import engine_scan as es  # noqa: E402
from repro_torch.kernels import dispersed_gemm as dg  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels.ref import cast_like  # noqa: E402
from repro_torch.models import Model, attention  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.serve import TRAFFIC_MIXES, ServeEngine, generate  # noqa: E402
from repro_torch.train import TrainConfig, Trainer  # noqa: E402

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
# The fused AdamW is timed in this many rounds, in turns with its twin
ADAMW_ROUNDS = 3
# Its least traffic a parameter: the bf16 gradient read twice (the norm,
# then the update), f32 m, v and master read and written, bf16 written
ADAMW_BYTES_PER_PARAM = 2 + 2 + 12 + 12 + 2
ADAMW_STEP = 101                  # the step the check takes (bias corrections)
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
        # qwen2-vl's prefill: D = 128, GQA 28/4 (groups of 7)
        ("vlm_28_4_d128_bshd", (4, 28, 512, 128), (4, 4, 512, 128),
         torch.bfloat16, True, True),
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
        # the reduced f32 whisper's encoder: 16 frames, D = 32, full
        ("audio_f32_d32_full", (2, 4, 16, 32), (2, 4, 16, 32),
         torch.float32, False, False),
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


def check_cluster_plan() -> None:
    """cluster_scan.cluster_scan_plan's tile (K2) against the built
    kernel's (cluster_scan_tile) for the shared memories [cluster] runs
    (the suites' 256 x 4 L2 is the widest)."""
    clusters = [cluster_sweep.CLUSTER] + _check_clusters()
    plan = cs.cluster_scan_plan(16, 2, [1], ([3], [0], [False]), clusters,
                                strides=[1], invariant=[True])
    ways = max(c.l2_ways for c in clusters if c.l2_sets)
    built = cs.built_tile(plan["l2_sets"], ways)
    log("build", cluster_scan_tile=f"{plan['l2_sets']}x{ways}", **built,
        cluster_scan_plan_agrees=built == plan["tile"])
    check(built == plan["tile"], f"cluster_scan_plan {plan['tile']} != the "
          f"built kernel's {built}")


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

def phase_trace(session) -> dict:
    """The trace layer on the host: build every rvv program at its
    paper_params and expand it into the engine's event matrices, printing
    the sizes the engine kernel takes (instructions T, active vector
    registers, the matrices' bytes as int32); T must equal TRACE_T.  Then,
    at reduced_params, the full-VRF interpreter against the dispersed one
    (FIFO, TRACE_CHECK_CAPACITY registers): memory and registers bitwise
    equal, and the outputs within the kernel's tolerance of its
    reference.  The programs are built through ``session`` (the [engine]
    and [paper] phases reuse them); returns them by name."""
    check(list(rvv.BENCHMARKS) == list(TRACE_T),
          f"rvv registry order {list(rvv.BENCHMARKS)}")
    t_phase = time.perf_counter()
    sizes, programs = {}, {}
    for name, bench in rvv.BENCHMARKS.items():
        t0 = time.perf_counter()
        prog = programs[name] = session.built(name).program
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
# instructions (Session._refine, the port's as the reference's)
REFINE_MAX_ROWS = api.REFINE_MAX_ROWS
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


def _engine_grid(session, programs, names, sweep, machine, preps,
                 fold=True):
    """simulate_grid on the card over the named paper-size programs,
    folded as the reference's Session folds them, then each program whose
    certificate failed at some grid point re-run unfolded if it has at
    most REFINE_MAX_ROWS rows.  ``preps`` records the prepared traces by
    (name, fold, L1 geometry) and the host seconds ``session.prepared``
    took for them (the [paper] phase's Session reuses them)."""
    def prep(name, fold):
        key = (name, fold, machine.l1_sets, machine.l1_ways)
        if key not in preps:
            t0 = time.perf_counter()
            preps[key] = (session.prepared(name, fold=fold,
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
# The cluster's kernels: K1a, K1b and K2
CLUSTER_KERNELS = dict(ENGINE_KERNELS, cluster_l2=cs.cluster_l2_cuda)


def phase_engine(session, programs) -> dict:
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
    folded, t3_refined = _engine_grid(session, programs, names, t3,
                                      simulator.DEFAULT_MACHINE, preps)
    pareto = {}
    for kb in PARETO_L1_KB:
        pareto[kb] = _engine_grid(session, programs, names, pareto_sweep,
                                  _l1_machine(kb), preps)
    unfolded = {}
    for name in names:
        out, _ = _engine_grid(session, programs, [name], t3,
                              simulator.DEFAULT_MACHINE, preps, fold=False)
        unfolded[name] = int(out["cycles"][0, 0])
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


# ------------------------------------------------------------------- paper --

# The paper suites [paper] runs through repro_torch.benchmarks.run, at
# paper size (kernel_params "paper", no max_events)
PAPER_SUITES = ("table3", "fig2", "fig4", "fig5", "fig6", "fig8", "pareto",
                "policy_headroom", "ablation_sensitivity")
# The suites whose kernel records BENCH_core.json holds, and how many of
# its values each has: 165 in all
HELD_SUITES = {"table3": 22, "pareto": 75, "policy_headroom": 36,
               "ablation_sensitivity": 32}
# The reference's own check of the engine (.claude/skills/verify/SKILL.md):
# pathfinder's fig4 row at capacity 3
FIG4_PATHFINDER_CAP3 = dict(norm_perf="0.5683", hit_rate="0.5",
                            spills="741", fills="868")
# The engine's plain versions, which must not run on the card's path, by
# the module that holds each: K1's and K2's
PLAIN_ENGINE = {"engine_scan_plain": es, "engine_split_plain": es,
                "engine_reg_plain": es, "engine_l1_plain": es,
                "cluster_scan_plain": cs, "cluster_split_plain": cs,
                "cluster_l2_plain": cs}


@contextlib.contextmanager
def plain_engine_calls():
    """Count the calls of the engine's plain versions while the block
    runs (they are looked up by name in kernels/engine_scan.py and
    kernels/cluster_scan.py, so a counting wrapper there sees every
    call)."""
    calls = dict.fromkeys(PLAIN_ENGINE, 0)
    saved = {name: getattr(mod, name) for name, mod in PLAIN_ENGINE.items()}

    def counted(name):
        def call(*args, **kw):
            calls[name] += 1
            return saved[name](*args, **kw)
        return call
    for name, mod in PLAIN_ENGINE.items():
        setattr(mod, name, counted(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(PLAIN_ENGINE[name], name, fn)


def _csv_rows(text: str, first_field: str) -> list[dict]:
    """The rows of the CSV block whose header starts with first_field."""
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith(first_field + ","))
    header = lines[start].split(",")
    rows = []
    for ln in lines[start + 1:]:
        if not ln or ln.startswith("#"):
            break
        rows.append(dict(zip(header, ln.split(","))))
    return rows


def _engine_device_ms(prof, names=KERNEL_NAMES, exclude=None
                      ) -> float | None:
    """The engine kernels' summed device ms in a profiler window: K1's
    by default (KERNEL_NAMES; ``exclude`` leaves out K2's, whose exclusive
    scan shares K1b's names), K2's with K2_KERNEL_NAMES; None where the
    profiler recorded none."""
    total = 0.0
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if us and names.search(e.key) and not (
                exclude and exclude.search(e.key)):
            total += us / 1e3
    return total or None


def phase_paper(session) -> dict:
    """The port's front door at paper size: python -m
    repro_torch.benchmarks.run, in this process, over PAPER_SUITES on the
    card through ``session`` (which already holds the traces the earlier
    phases prepared), one suite at a time under torch.profiler (the
    engine kernels' device time).  Holds the report's kernel records
    exactly to BENCH_core.json on every key of HELD_SUITES (165 values,
    all present), its metrics block (names and kinds) and macro_models
    block to BENCH_core.json's, fig4's pathfinder row at capacity 3 to
    FIG4_PATHFINDER_CAP3; K1a and K1b must launch and no plain version of
    the engine may run.  Writes the merged report to
    chiprun_out/paper_report.json."""
    from torch.profiler import ProfilerActivity, profile

    bench = json.loads((ROOT / "BENCH_core.json").read_text())
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    t_phase = time.perf_counter()
    report, per_suite, stdout = None, {}, {}
    with plain_engine_calls() as plain:
        for suite in PAPER_SUITES:
            path = out_dir / f"paper_{suite}.json"
            text = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                    contextlib.redirect_stdout(text):
                rc = bench_run.main(["--json", str(path), suite],
                                    session=session)
                torch.cuda.synchronize()
            k1_ms = _engine_device_ms(prof)
            check(rc == 0, f"paper: run.py {suite} exited {rc}")
            stdout[suite] = text.getvalue()
            rep = json.loads(path.read_text())
            rec = rep["suites"][suite]
            per_suite[suite] = dict(
                rows=rec["rows"], wall_s=rec["wall_s"],
                prepare_s=rec["prepare_s"], engine_s=rec["engine_s"],
                dispatches=rec["dispatches"], launches=rec["launches"],
                k1_device_ms=k1_ms,
                # the suite's wall time with the profiler's start, stop
                # and key_averages around it
                profiled_s=round(time.perf_counter() - t0, 3))
            log("paper", suite=suite, **per_suite[suite])
            if report is None:
                report = rep
            else:
                report["suites"].update(rep["suites"])
                for name, keys in rep["kernels"].items():
                    report["kernels"].setdefault(name, {}).update(keys)
    seconds = time.perf_counter() - t_phase
    (out_dir / "paper_report.json").write_text(
        json.dumps(report, indent=1, sort_keys=True))
    check(not any(plain.values()), f"paper: a plain version of the "
          f"engine ran on the card's path: {plain}")

    held, missing, wrong = 0, [], []
    for name, keys in bench["kernels"].items():
        for key, want in keys.items():
            suite = key.split(".")[0]
            suite = next((s for s in HELD_SUITES if suite == s
                          or suite.startswith(s + "_")), None)
            if suite is None:
                continue
            got = report["kernels"].get(name, {}).get(key)
            if got is None:
                missing.append(f"{name}:{key}")
            elif got != want:
                wrong.append(f"{name}:{key} {got} != {want}")
            else:
                held += 1
    want_held = sum(HELD_SUITES.values())
    log("paper", held_to_bench=held, equal=not missing and not wrong
        and held == want_held)
    check(not missing, f"paper: BENCH_core.json keys missing: {missing}")
    check(not wrong, f"paper: values differ from BENCH_core.json: {wrong}")
    check(held == want_held, f"paper: held {held} values, want "
          f"{want_held}")
    kinds = {n: m["kind"] for n, m in report["metrics"].items()}
    check(kinds == {n: m["kind"] for n, m in bench["metrics"].items()},
          f"paper: the metrics block differs from BENCH_core.json's: "
          f"{sorted(kinds)}")
    check(report["macro_models"] == bench["macro_models"],
          "paper: macro_models differ from BENCH_core.json's")
    row = next(r for r in _csv_rows(stdout["fig4"], "name")
               if r["name"] == "pathfinder" and r["capacity"] == "3")
    got = {k: row[k] for k in FIG4_PATHFINDER_CAP3}
    log("paper", fig4_pathfinder_cap3=got,
        equal=got == FIG4_PATHFINDER_CAP3)
    check(got == FIG4_PATHFINDER_CAP3, f"paper: fig4 pathfinder at "
          f"capacity 3 is {got}, want {FIG4_PATHFINDER_CAP3}")
    launches = {k: sum(s["launches"][k] for s in per_suite.values())
                for k in ENGINE_KERNELS}
    log("paper", seconds=round(seconds, 2), metrics=len(kinds),
        macro_models=sorted(report["macro_models"]), launches=launches,
        plain_calls=plain)
    return dict(suites=per_suite, held=held, seconds=seconds,
                launches=launches)


# ----------------------------------------------------------------- cluster --

# The cluster suites [cluster] runs through repro_torch.benchmarks.run at
# paper size, and the numeric fields of their rows BENCH_core.json holds
# (us_per_call, the wall clock, aside): 10 x 72 and 9 x 108 values
CLUSTER_ROW_FIELDS = {
    "cluster_sweep": ("aggregate_throughput", "cluster_area",
                      "contention_stall_ratio", "contention_stalls",
                      "core_cycles_sum", "cycles", "l2_hits", "l2_misses",
                      "scaled_cycles", "sram_budget_bytes"),
    "dse": ("area_flop", "area_sram6t", "area_table", "cycles",
            "energy_flop", "energy_sram6t", "energy_table", "fold_exact",
            "scaled_cycles")}
# The rows' axis labels, which locate a row
CLUSTER_ROW_KEYS = ("name", "capacity", "l1_kb", "cores")
# The summaries and fronts held too; their rows' plan-group provenance
# (the reference's shape bucket and group index, and whether the engine
# call was fused) differs on purpose and is left out
CLUSTER_EXTRA_HELD = {
    "cluster_sweep": ("fold_exact_fraction", "iso_budget_front",
                      "iso_area_front"),
    "dse": ("fold_exact_fraction", "fronts", "fronts_2d",
            "iso_area_winners", "external_baseline")}
CLUSTER_PROVENANCE = ("plan_group", "bucket", "fused")
# K2 against the split's plain versions: these core counts behind these
# shared memories (the default, the passthrough, no L2 on two channels,
# the suites' 256 x 4 L2 on two channels, an odd 32 x 3 on three)
CLUSTER_CHECK_CORES = (1, 2, 4, 8)
K2_KERNEL_NAMES = re.compile(
    r"cluster_(mark|compact|lanes|bucket|walk|arbiter|finish)"
    r"|scan_(sums|blocks|apply)(_dev)?<1>")


def _check_clusters() -> list:
    return [c for n in CLUSTER_CHECK_CORES for c in (
        ClusterConfig(n_cores=n), ClusterConfig.passthrough(n),
        ClusterConfig(n_cores=n, l2_sets=0, mem_channels=2),
        ClusterConfig(n_cores=n, l2_sets=256, l2_ways=4, mem_channels=2),
        ClusterConfig(n_cores=n, l2_sets=32, l2_ways=3, mem_channels=3))]


def _cluster_inputs(preps, sweep, machines):
    """simulate_clusters' inputs to the cluster scan over ``preps``."""
    x, spill0s, cfg, mach, kw = _engine_inputs(preps, sweep, machines)
    return x, spill0s, [cluster_engine._stride(p) for p in preps], cfg, \
        mach, kw


def time_k2(x, spill0s, strides, cfg, mach, clusters, kw) -> dict:
    """K2 alone on the card (engine_timing's _k2_alone: per launch group
    K1a and K1b once, K1b's buffers kept, then K2's time by CUDA events
    over ENGINE_ITERS calls after a warm-up, the host's time to issue a
    call, and one call's device ms per kernel, memset and copy, whose sum
    and the host gap make up K2's ms; its compacted L1 misses,
    candidates, bucketed requests and largest (lane, L2 set) bucket), the
    device time before the walk, and K2's bound: the larger of K1b's
    records (8 bytes) and outcomes (1 byte) read once with the per-core
    counters written once, over HBM, and ENGINE_OPS_PER_WAY operations on
    each L2 way per bucketed request over the CUDA cores' peak."""
    out = _k2_alone(cs, es, x, spill0s, strides, cfg, mach, clusters, kw)
    sets = 3 if kw["track_ab"] else 1
    ways = max((c.l2_ways for c in clusters if c.l2_sets), default=0)
    nbytes = (out["records"] * 9 + sets * out["per_core_outputs"]
              * len(mach[0]) * cs.CLUSTER_COUNTERS * 4)
    ops = ENGINE_OPS_PER_WAY * ways * out["bucketed_requests"]
    out["bound_ms"], out["bound_by"] = bound_ms(nbytes, ops, torch.float32)
    out["before_walk_device_ms"] = out["device_ms"] - sum(
        ms for name, ms in out["per_kernel_ms"].items() if name.startswith(
            ("cluster_walk", "cluster_arbiter", "cluster_finish")))
    out["ns_per_chain_step"] = (out["ms"] * 1e6 / out["largest_bucket"]
                                if out["largest_bucket"] else None)
    return out


def check_k2_buckets(label, x, spill0s, strides, cfg, mach, clusters, kw,
                     plain_keeps) -> dict:
    """K2's own buffers against their plain versions, per launch group:
    the card's K1a and K1b (its buffers kept) feed cluster_l2_cuda, which
    hands back its compacted L1-miss stream (row offsets, and each miss's
    line, row and site), each K2 lane's first candidate and its request
    buckets (each request's line and candidate, each (lane, L2 set)
    bucket's offsets); miss_stream_plain and request_buckets_plain give
    them from K1b's plain accesses and outcomes of the same group
    (``plain_keeps``: the (group, keep) pairs of the plain run), and every
    entry must be equal."""
    lengths = kw["lengths"]
    out = dict(groups=0, misses=0, candidates=0, requests=0, lanes=0,
               per_core_lanes=0)
    for g, keep_plain in plain_keeps:
        stream, ctr = _no_stream(x)
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
        got = {}
        cs.cluster_l2_cuda(x, keep, g, k1_outs, mach, clusters,
                           l1_sets=kw["l1_sets"], track_ab=kw["track_ab"],
                           lengths=lengths, buffers=got)
        want_stream = cs.miss_stream_plain(keep_plain, g, lengths)
        want = cs.request_buckets_plain(want_stream, g, [
            cs._cluster(c) for c in clusters])
        pairs = [("row_off", got["row_off"], want_stream["row_off"]),
                 ("miss_line", got["miss_line"], want_stream["line"]),
                 ("miss_row", got["miss_row"], want_stream["row"]),
                 ("miss_site", got["miss_site"], want_stream["site"]),
                 ("req_line", got["req_line"], want["req_line"]),
                 ("req_cand", got["req_cand"], want["req_cand"])]
        pairs += [(f"bucket_start[{k}]", a, b) for k, (a, b) in enumerate(
            zip(got["bucket_start"], want["bucket_start"]))]
        for name, a, b in pairs:
            check(a.shape == b.shape and torch.equal(a.cpu(), b.cpu()),
                  f"cluster {label}: K2's {name} differs from its plain "
                  f"version ({tuple(a.shape)} vs {tuple(b.shape)})")
        check(got["cand_base"] == want["cand_base"], f"cluster {label}: "
              f"K2's candidate bases differ from their plain version")
        out["groups"] += 1
        out["misses"] += int(want_stream["line"].numel())
        out["candidates"] += want["cand_base"][-1]
        out["requests"] += int(want["req_line"].numel())
        out["lanes"] += len(g["k2_lanes"])
        out["per_core_lanes"] += sum(len(set(v[3])) > 1
                                     for v in g["k2_lanes"])
    log("cluster", check=f"{label}_buckets", equal=True, **out)
    return out


def check_cluster_kernel(label, preps, sweep, machines, clusters,
                         depth=None, edge=()) -> dict:
    """The cluster on the card (cluster_scan_cuda: K1a, K1b, K2) against
    the split's plain versions on the host's CPU (engine_l1_plain then
    cluster_l2_plain, as cluster_split_plain runs them, fed K1a's cVRF
    pass from the card: K1a is held to engine_reg_plain by [engine] on
    these reduced programs, and its plain version would take most of the
    check's time) on the same inputs, every cluster point, all three
    counter sets of all 15 per-core counters, bitwise; the plain
    versions' host ms (K2's own apart) and K2's device ms on those
    inputs.  ``depth`` cuts each trace to its first rows; the programs
    of ``edge`` have their spill region moved so near 2^31 that the
    cores' shifted lines leave the int32 range, which gives each of their
    cores a K1b lane of its own (K2's per-core lanes)."""
    if depth is not None:
        preps = [simulator._slice_prep(p, min(p.num_rows, depth))
                 for p in preps]
    x_cpu, spill0s, strides, cfg, mach, kw = _cluster_inputs(
        preps, sweep, machines)
    if edge:
        spill0s = np.array(spill0s, np.int64)
        for p in edge:
            spill0s[p] = 2 ** 31 - 3 * strides[p] - 20
    x = x_cpu.cuda()
    k2_plain_s = [0.0]
    plain_keeps = []

    def card_reg(_, prog, reg_cfg, **kwargs):
        return tuple(t.cpu() for t in es.engine_reg_cuda(x, prog, reg_cfg,
                                                         **kwargs))

    def timed_l2(*args, **kwargs):
        plain_keeps.append((args[2], args[1]))
        t0 = time.perf_counter()
        out = cs.cluster_l2_plain(*args, **kwargs)
        k2_plain_s[0] += time.perf_counter() - t0
        return out
    t0 = time.perf_counter()
    want = cs._cluster_run(x_cpu, spill0s, strides, cfg, mach, clusters,
                           reg_fn=card_reg, l1_fn=es.engine_l1_plain,
                           k2_fn=timed_l2, **kw)
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = cs.cluster_scan_cuda(x, spill0s, strides, cfg, mach, clusters,
                               **kw)
    torch.cuda.synchronize()
    err = 0
    for cl, w, g in zip(clusters, want, got):
        for a, b, name in zip(w, g, ("ctr", "ctr_a", "ctr_b")):
            diff = _max_diff(b, a)
            err = max(err, diff)
            check(diff == 0, f"cluster {label}: K2 {name} differs from the "
                  f"split's plain versions by up to {diff} at {cl}")
    buckets = check_k2_buckets(label, x, spill0s, strides, cfg, mach,
                               clusters, kw, plain_keeps)
    del plain_keeps
    check(buckets["per_core_lanes"] > 0 or not edge, f"cluster {label}: "
          f"no per-core K2 lane")
    k2 = time_k2(x, spill0s, strides, cfg, mach, clusters, kw)
    out = dict(programs=len(preps), rows=max(kw["lengths"]),
               configs=len(sweep), machines=len(machines),
               clusters=len(clusters), max_abs_err=err,
               plain_ms=plain_ms, k2_plain_ms=k2_plain_s[0] * 1e3,
               k2_ms=k2["ms"], k2_device_ms=k2["device_ms"],
               k2_host_issue_ms=k2["host_issue_ms"],
               k2_host_issue_first_ms=k2["host_issue_first_ms"],
               k2_per_kernel_ms=k2["per_kernel_ms"], k2_lanes=k2["k2_lanes"],
               k2_largest_bucket=k2["largest_bucket"],
               k2_compacted_misses=buckets["misses"],
               k2_requests=buckets["requests"],
               k2_per_core_lanes=buckets["per_core_lanes"])
    log("cluster", check=label, equal=True, **out)
    return dict(out, x=x, inputs=(spill0s, strides, cfg, mach, kw), got=got)


@contextlib.contextmanager
def k2_buckets():
    """K2's largest (lane, L2 set) bucket over the launches made while
    the block runs: cluster_l2_cuda is looked up by name in
    kernels/cluster_scan.py, so a wrapper there asks each launch for its
    bucket sizes (one synchronisation a launch).  The wrapper lends the
    wrapped function's ``count``, which the function reaches by that
    name, so the launches still count where they did."""
    seen = dict(largest_bucket=0, bucketed_requests=0, compacted_misses=0)
    wrapped = cs.cluster_l2_cuda

    def call(*args, **kw):
        stats = {}
        out = wrapped(*args, stats=stats, **kw)
        seen["largest_bucket"] = max(seen["largest_bucket"],
                                     stats["largest_bucket"])
        seen["bucketed_requests"] += stats["bucketed_requests"]
        seen["compacted_misses"] += stats["compacted_misses"]
        return out
    call.count = wrapped.count
    cs.cluster_l2_cuda = call
    try:
        yield seen
    finally:
        cs.cluster_l2_cuda = wrapped


def _held_rows(label, got, want, fields) -> tuple[int, list]:
    """Every field of every BENCH_core.json row against the run's row at
    the same labels: equal ints, and floats equal as Python floats."""
    index = {tuple(r[k] for k in CLUSTER_ROW_KEYS): r for r in got}
    held, wrong = 0, []
    check(len(got) == len(want), f"{label}: {len(got)} rows, "
          f"BENCH_core.json {len(want)}")
    for w in want:
        g = index.get(tuple(w[k] for k in CLUSTER_ROW_KEYS))
        check(g is not None, f"{label}: no row for {w}")
        for f in fields:
            if type(g[f]) is not type(w[f]) or g[f] != w[f]:
                wrong.append(f"{label} {[w[k] for k in CLUSTER_ROW_KEYS]} "
                             f"{f}: {g[f]!r} != {w[f]!r}")
            else:
                held += 1
    return held, wrong


def _without_provenance(v):
    if isinstance(v, dict):
        return {k: _without_provenance(x) for k, x in v.items()
                if k not in CLUSTER_PROVENANCE}
    if isinstance(v, list):
        return [_without_provenance(x) for x in v]
    return v


def phase_cluster(session) -> dict:
    """The cluster (P4) with K2 on the card.  K2 against the split's plain
    versions (bitwise, every cluster point of _check_clusters(): N = 1,
    2, 4, 8 behind five shared memories) on the [engine] twin check's
    reduced inputs (every rvv program, CONF_POINTS' configs and
    machines), on gemv and dropout with dropout's spill region at the
    int32 edge (per-core K1b lanes), and on the cluster suites' paper
    inputs cut to ENGINE_CHECK_ROWS rows; the N = 1 passthrough equal to
    K1's counters on the card.  Then the main path: cluster_sweep and dse through
    repro_torch.benchmarks.run in this process at paper size, through
    ``session``, each under torch.profiler: every numeric field of every
    row held exactly to BENCH_core.json (720 and 972 values), their
    summaries and fronts too (provenance aside); K1a, K1b and K2 launched,
    no plain version of the engine run.  Last, K2 alone on cluster_sweep's
    4 KB grid (its largest bucket, device ms, bound)."""
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    clusters = _check_clusters()
    built = {n: b.build(**b.reduced_params).program
             for n, b in rvv.BENCHMARKS.items()}
    sweep = simulator.SweepConfig(
        np.asarray([c for c, _, _ in CONF_POINTS], np.int32),
        np.asarray([p for _, p, _ in CONF_POINTS], np.int32),
        np.zeros(len(CONF_POINTS), bool))
    machines = simulator.MachineSweep.from_params(
        [m for _, _, m in CONF_POINTS])
    reduced = check_cluster_kernel(
        "reduced", [simulator.prepare(p) for p in built.values()], sweep,
        machines, clusters)
    per_core = check_cluster_kernel(
        "reduced_per_core_lanes",
        [simulator.prepare(built[n]) for n in ("gemv", "dropout")], sweep,
        machines, clusters, edge=(1,))
    for key in ("x", "inputs", "got"):
        per_core.pop(key)
    # The passthrough identity: one core, no L2, no queue -> K1's counters
    x = reduced.pop("x")
    spill0s, strides, cfg, mach, kw = reduced.pop("inputs")
    k1 = es.engine_scan_cuda(x, spill0s, cfg, mach, **kw)
    i1 = clusters.index(ClusterConfig.passthrough(1))
    got = reduced.pop("got")[i1]
    diff = max(_max_diff(g[..., 0, :es.NUM_COUNTERS], k) for g, k in zip(
        got, k1))
    log("cluster", check="passthrough_n1_vs_k1", equal=diff == 0)
    check(diff == 0, f"cluster: passthrough(1) differs from K1 by {diff}")
    del x

    bench = json.loads((ROOT / "BENCH_core.json").read_text())["suites"]
    paper_cut = {}
    for suite, mod in (("cluster_sweep", cluster_sweep), ("dse", dse)):
        kb = mod.L1_KBYTES[0]
        m = _l1_machine(kb)
        sw = simulator.SweepConfig.make(mod.CAPS)
        cl = [dataclasses.replace(mod.CLUSTER, n_cores=n) for n in mod.CORES]
        paper_cut[suite] = check_cluster_kernel(
            f"{suite}_{kb}kb_first_{ENGINE_CHECK_ROWS}_rows",
            [session.prepared(n, fold=True, machine=m) for n in mod.KERNELS],
            sw, simulator.MachineSweep.from_params([m]), cl,
            depth=ENGINE_CHECK_ROWS)
        for key in ("x", "inputs", "got"):
            paper_cut[suite].pop(key)

    for fn in CLUSTER_KERNELS.values():
        fn.launches = 0
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    per_suite, held, wrong = {}, 0, []
    t_main = time.perf_counter()
    with plain_engine_calls() as plain:
        for suite in CLUSTER_ROW_FIELDS:
            path = out_dir / f"cluster_{suite}.json"
            text = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                    contextlib.redirect_stdout(text), k2_buckets() as k2b:
                rc = bench_run.main(["--json", str(path), suite],
                                    session=session)
                torch.cuda.synchronize()
            check(rc == 0, f"cluster: run.py {suite} exited {rc}")
            rec = json.loads(path.read_text())["suites"][suite]
            want = bench[suite]["extra"]
            h, w = _held_rows(suite, rec["extra"]["rows"], want["rows"],
                              CLUSTER_ROW_FIELDS[suite])
            held += h
            wrong += w
            for key in CLUSTER_EXTRA_HELD[suite]:
                if _without_provenance(rec["extra"][key]) != \
                        _without_provenance(want[key]):
                    wrong.append(f"{suite} extra.{key}")
            per_suite[suite] = dict(
                rows=rec["rows"], wall_s=rec["wall_s"],
                prepare_s=rec["prepare_s"], engine_s=rec["engine_s"],
                dispatches=rec["dispatches"], launches=rec["launches"],
                plan_groups=rec["extra"]["plan_groups"],
                fold_exact_fraction=rec["extra"]["fold_exact_fraction"],
                k1_device_ms=_engine_device_ms(prof, exclude=K2_KERNEL_NAMES),
                k2_device_ms=_engine_device_ms(prof, K2_KERNEL_NAMES),
                k2_largest_bucket=k2b["largest_bucket"],
                k2_bucketed_requests=k2b["bucketed_requests"],
                k2_compacted_misses=k2b["compacted_misses"],
                held=h, profiled_s=round(time.perf_counter() - t0, 3))
            log("cluster", suite=suite, **per_suite[suite])
    main_s = time.perf_counter() - t_main
    launches = {name: fn.launches for name, fn in CLUSTER_KERNELS.items()}
    want_held = sum(len(bench[s]["extra"]["rows"]) * len(f)
                    for s, f in CLUSTER_ROW_FIELDS.items())
    log("cluster", held_to_bench=held, want=want_held,
        equal=not wrong and held == want_held, launches=launches,
        plain_calls=plain, main_path_s=round(main_s, 2))
    check(not wrong, f"cluster: values differ from BENCH_core.json: "
          f"{wrong[:20]}")
    check(held == want_held, f"cluster: held {held} values, want "
          f"{want_held}")
    check(all(launches.values()), f"cluster: a kernel of the main path was "
          f"never launched: {launches}")
    check(not any(plain.values()), f"cluster: a plain version of the "
          f"engine ran on the card's path: {plain}")

    # K2 alone on cluster_sweep's 4 KB grid at paper size (outside the
    # counted run): every program, capacity and core count in one call
    m4 = _l1_machine(cluster_sweep.L1_KBYTES[0])
    x_cpu, spill0s, strides, cfg, mach, kw = _cluster_inputs(
        [session.prepared(n, fold=True, machine=m4)
         for n in cluster_sweep.KERNELS],
        simulator.SweepConfig.make(cluster_sweep.CAPS),
        simulator.MachineSweep.from_params([m4]))
    timing = time_k2(x_cpu.cuda(), spill0s, strides, cfg, mach,
                     [dataclasses.replace(cluster_sweep.CLUSTER, n_cores=n)
                      for n in cluster_sweep.CORES], kw)
    log("cluster", timing="cluster_sweep_4kb_folded", **timing)
    seconds = time.perf_counter() - t_phase
    log("cluster", seconds=round(seconds, 2))
    return dict(reduced=reduced, per_core=per_core, paper_cut=paper_cut,
                suites=per_suite,
                held=held, launches=launches, timing=timing,
                main_path_s=main_s, seconds=seconds)


# ----------------------------------------------------------------- network --

# The fields of network_sweep's rows held to BENCH_core.json (every field
# but the wall clock's us_per_call), the labels that locate a row, and
# the summaries held beside them
NETWORK_ROW_KEYS = ("name", "capacity", "l1_kb")
NETWORK_EXTRA_HELD = ("networks", "points", "fold_exact_fraction")


def phase_network() -> dict:
    """The bridge (P6) on the card: python -m
    repro_torch.benchmarks.run network_sweep, in this process, uncut (5
    models lowered to 35 net:* kernels, 5 capacities, 2 L1 geometries:
    350 points) through a new Session under torch.profiler.  Every field
    of its 50 rows but us_per_call held exactly to BENCH_core.json, and
    its networks, points (350) and fold_exact_fraction (1.0); K1a and K1b
    launched, no plain version of the engine run.  Reports the wall,
    prepare and engine seconds, engine calls, launches and K1's device
    ms."""
    from torch.profiler import ProfilerActivity, profile

    want = json.loads((ROOT / "BENCH_core.json").read_text())[
        "suites"]["network_sweep"]["extra"]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / "network_sweep.json"
    for fn in ENGINE_KERNELS.values():
        fn.launches = 0
    text = io.StringIO()
    with plain_engine_calls() as plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                contextlib.redirect_stdout(text):
            rc = bench_run.main(["--json", str(path), "network_sweep"],
                                session=api.Session())
            torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in ENGINE_KERNELS.items()}
    check(rc == 0, f"network: run.py network_sweep exited {rc}")
    rec = json.loads(path.read_text())["suites"]["network_sweep"]
    got = rec["extra"]
    index = {tuple(r[k] for k in NETWORK_ROW_KEYS): r for r in got["rows"]}
    held, wrong = 0, []
    check(len(got["rows"]) == len(want["rows"]) == 50,
          f"network: {len(got['rows'])} rows, BENCH_core.json "
          f"{len(want['rows'])}")
    for w in want["rows"]:
        g = index.get(tuple(w[k] for k in NETWORK_ROW_KEYS))
        check(g is not None, f"network: no row for {w}")
        check(set(g) == set(w), f"network: row fields {sorted(g)}")
        for f in sorted(set(w) - {"us_per_call"}):
            if type(g[f]) is not type(w[f]) or g[f] != w[f]:
                wrong.append(f"{[w[k] for k in NETWORK_ROW_KEYS]} {f}: "
                             f"{g[f]!r} != {w[f]!r}")
            else:
                held += 1
    for key in NETWORK_EXTRA_HELD:
        if got[key] != want[key]:
            wrong.append(f"extra.{key}")
    out = dict(rows=rec["rows"], wall_s=rec["wall_s"],
               prepare_s=rec["prepare_s"], engine_s=rec["engine_s"],
               dispatches=rec["dispatches"], launches=launches,
               points=got["points"], kernels=len({
                   k for n in got["networks"] for k in n["kernels"]}),
               fold_exact_fraction=got["fold_exact_fraction"],
               k1_device_ms=_engine_device_ms(prof), held=held,
               profiled_s=round(profiled_s, 3))
    log("network", **out, plain_calls=plain)
    log("network", held_to_bench=held, equal=not wrong)
    check(not wrong, f"network: values differ from BENCH_core.json: "
          f"{wrong[:20]}")
    check(got["points"] == 350 and got["fold_exact_fraction"] == 1.0,
          f"network: points {got['points']}, fold_exact_fraction "
          f"{got['fold_exact_fraction']}")
    check(all(rec["launches"][k] == n for k, n in launches.items())
          and all(launches.values()),
          f"network: K1 launches {launches}, the report's "
          f"{rec['launches']}")
    check(not any(plain.values()), f"network: a plain version of the "
          f"engine ran on the card's path: {plain}")
    return out


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


# --------------------------------------------------------------------- moe --

MOE_DEEPSEEK = "deepseek-v2-lite-16b"
MOE_PHI = "phi3.5-moe-42b-a6.6b"
# phi3.5-moe's 32 layers hold 83.7 GB of bf16 weights, more than the
# card's 80 GB: its full-width check runs the first 16 (42.1 GB)
MOE_PHI_LAYERS = 16
# A token whose top-k expert set differs between two runs must sit on a
# near-tie of its router: the k-th and (k+1)-th probabilities (f32)
# closer than this
ROUTE_TIE = 1e-5
MOE_DECODE_STEPS = 8
# Reduced f32 model on the card vs the same weights on the CPU
MOE_TOL = 1e-3


def weight_gb(model) -> float:
    return sum(p.numel() * p.element_size()
               for p in model.parameters()) / 1e9


@contextlib.contextmanager
def recorded_routes():
    """Every MoE routing decision made inside, as (probs, expert ids) on
    the host, one entry per MoE layer call (mlp.moe looks ``route`` up at
    each call)."""
    calls, route = [], tmlp.route

    def recording(p, cfg, x):
        out = route(p, cfg, x)
        calls.append((out[0].float().cpu(), out[2].cpu()))
        return out

    tmlp.route = recording
    try:
        yield calls
    finally:
        tmlp.route = route


@contextlib.contextmanager
def pinned_routes(recorded):
    """Every MoE call inside takes the expert ids of a recorded run (in
    call order), with gates from its own router probabilities."""
    calls, route = iter(recorded), tmlp.route

    def pinned(p, cfg, x):
        probs = route(p, cfg, x)[0]
        ids = next(calls)[1].to(x.device)
        gate = probs.gather(-1, ids)
        return probs, gate / gate.sum(-1, keepdim=True).clamp(min=1e-9), ids

    tmlp.route = pinned
    try:
        yield
    finally:
        tmlp.route = route


def first_divergence(got, want, k) -> dict:
    """For the tokens of one forward whose expert sets differ between two
    recorded runs at some layer: how many, how many differ first at the
    first MoE layer (whose inputs differ only by the attention's
    rounding: no other token has diverged yet), and the largest gap
    between the k-th and (k+1)-th router probability of ``want`` there."""
    bad = torch.stack([(a.sort(-1).values != b.sort(-1).values).any(-1)
                       for (_, a), (_, b) in zip(got, want)])   # (L,B,S)
    top = want[0][0].topk(k + 1, -1).values
    gaps = (top[..., k - 1] - top[..., k])[bad[0]]
    return dict(tokens=int(bad.any(0).sum()),
                at_first_layer=int(bad[0].sum()),
                max_gap=float(gaps.max()) if gaps.numel() else 0.0)


def route_differences(got, want, k) -> tuple[int, int]:
    """Tokens whose top-k expert sets differ between two recorded runs,
    and how many of those are near-ties (gap between the k-th and (k+1)-th
    probability of ``want`` under ROUTE_TIE)."""
    check(len(got) == len(want), f"{len(got)} vs {len(want)} MoE calls")
    differ = ties = 0
    for (_, ids_a), (probs_b, ids_b) in zip(got, want):
        bad = (ids_a.sort(-1).values != ids_b.sort(-1).values).any(-1)
        if bool(bad.any()):
            top = probs_b.topk(k + 1, -1).values[bad]
            differ += int(bad.sum())
            ties += int(((top[:, k - 1] - top[:, k]) < ROUTE_TIE).sum())
    return differ, ties


def check_moe_reduced(cfg, impl: str, seed: int) -> dict:
    """A reduced f32 copy of ``cfg`` on the card against the same weights
    on the CPU: prefill logits and MOE_DECODE_STEPS decode steps (logits,
    and the caches at the end) within MOE_TOL; tokens routed to another
    expert set must be near-ties."""
    small = dataclasses.replace(cfg.reduced(), dtype="float32",
                                attn_impl=impl)
    m_gpu = Model(small, device="cuda")
    m_gpu.init(torch.Generator(device="cuda").manual_seed(seed))
    m_cpu = Model(small, device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in
                           m_gpu.state_dict().items()})
    sb = _prompt_batch(small, 2, 128, "cpu", seed=seed + 1)
    with recorded_routes() as r_gpu:
        got = m_gpu.prefill({k: v.cuda() for k, v in sb.items()}).cpu()
    with recorded_routes() as r_cpu:
        want = m_cpu.prefill(sb)
    prefill_err = float((got - want).abs().max())
    differ, ties = route_differences(r_gpu, r_cpu, small.moe_top_k)

    b, smax = 2, 2 * MOE_DECODE_STEPS
    c_gpu, c_cpu = m_gpu.init_cache(b, smax), m_cpu.init_cache(b, smax)
    toks = sb["tokens"][:, :MOE_DECODE_STEPS]
    decode_err = 0.0
    for t in range(MOE_DECODE_STEPS):
        step = {"tokens": toks[:, t:t + 1],
                "positions": torch.full((b, 1), t, dtype=torch.long)}
        with recorded_routes() as r_gpu:
            lg, c_gpu = m_gpu.decode_step(
                c_gpu, {k: v.cuda() for k, v in step.items()})
        with recorded_routes() as r_cpu:
            lc, c_cpu = m_cpu.decode_step(c_cpu, step)
        decode_err = max(decode_err, float((lg.cpu() - lc).abs().max()))
        d, t_ = route_differences(r_gpu, r_cpu, small.moe_top_k)
        differ, ties = differ + d, ties + t_
    cache_err = max(float((c_gpu[k].cpu() - c_cpu[k]).abs().max())
                    for k in c_cpu)
    out = dict(arch=cfg.name, impl=impl, prefill_err=prefill_err,
               decode_err=decode_err, decode_steps=MOE_DECODE_STEPS,
               cache_keys="/".join(c_cpu), cache_err=cache_err,
               route_differ=differ, route_near_ties=ties, tol=MOE_TOL)
    log("moe", check="reduced_f32_card_vs_cpu", **out)
    check(max(prefill_err, decode_err, cache_err) <= MOE_TOL,
          f"reduced {cfg.name} on the card off by {out}")
    check(ties == differ, f"{differ - ties} tokens of reduced {cfg.name} "
          "took another expert set on the card without a near-tie")
    return out


def phase_moe_deepseek(model) -> dict:
    """Full-width, full-depth deepseek-v2-lite prefill (MLA, a leading
    dense layer, 64 routed experts top-6 and 2 shared) on 4 x 512 tokens:
    logits of the right shape, finite, and a finite aux loss >= 0."""
    cfg = model.cfg
    batch = _prompt_batch(cfg, PREFILL_BATCH, PREFILL_LEN, "cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, aux = model.train_logits(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    aux = float(aux)
    out = dict(arch=cfg.name, layers=cfg.num_layers,
               dense_layers=cfg.first_dense_layers, d=cfg.d_model,
               experts=cfg.num_experts, top_k=cfg.moe_top_k,
               shared=cfg.num_shared_experts, kv_lora_rank=cfg.kv_lora_rank,
               dtype=cfg.dtype, tokens=f"{PREFILL_BATCH}x{PREFILL_LEN}",
               first_call_s=round(wall, 3), aux=aux,
               peak_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))
    log("moe", **out)
    check(logits.shape == (PREFILL_BATCH, PREFILL_LEN, cfg.vocab_size),
          f"deepseek prefill logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()),
          "non-finite deepseek prefill logits")
    check(np.isfinite(aux) and aux >= 0.0, f"deepseek aux loss {aux}")
    out["reduced"] = check_moe_reduced(cfg, "sdpa", seed=4)
    return out


def check_layers_flash(model, batch) -> dict:
    """K5 on the main path's own inputs: each layer's attention block
    through flash against sdpa on the same normed input (the sdpa run's),
    within the bf16 tolerance of the kernel checks (TOL)."""
    cfg = model.cfg
    x, pos = model._embed(batch), model._positions(batch)
    out = dict(ok=True, max_abs_err=0.0, max_abs_attn=0.0)
    with torch.no_grad():
        for blk in model.blocks:
            h = model._norm(blk.norm1, x)
            want = attention.attention(blk.mixer, cfg, h, pos, impl="sdpa")
            got = attention.attention(blk.mixer, cfg, h, pos, impl="flash")
            ok, err = _close(got, want, *TOL[torch.bfloat16])
            out["ok"] &= ok
            out["max_abs_err"] = max(out["max_abs_err"], err)
            out["max_abs_attn"] = max(out["max_abs_attn"],
                                      float(want.float().abs().max()))
            x = x + want
            x = x + model._ffn(blk, model._norm(blk.norm2, x))[0]
    return out


def phase_moe_phi(model) -> dict:
    """Full-width phi3.5-moe (depth cut to MOE_PHI_LAYERS) prefill on 4 x
    512 tokens through the flash kernel (D = 128, GQA 32/8): one K5
    launch per layer, all on the tensor cores, and K5 against sdpa layer
    by layer on the prefill's own inputs; the end-to-end comparison with
    the sdpa path is reported (see below).  Then a reduced f32 copy
    through flash on the card vs the CPU."""
    cfg = model.cfg
    batch = _prompt_batch(cfg, PREFILL_BATCH, PREFILL_LEN, "cuda")
    with recorded_routes() as r_sdpa:
        t0 = time.perf_counter()
        sdpa = _prefill(model, "sdpa", batch)
        t_sdpa = time.perf_counter() - t0
    with recorded_routes() as r_flash:
        fa.flash_attention_cuda.launches = 0
        t0 = time.perf_counter()
        flash = _prefill(model, "flash", batch)
        t_flash = time.perf_counter() - t0
        launches = fa.flash_attention_cuda.launches
        launches_tc = fa.flash_attention_cuda.launches_tc
    check(flash.shape == (PREFILL_BATCH, PREFILL_LEN, cfg.vocab_size),
          f"phi3.5-moe prefill logits shape {tuple(flash.shape)}")
    check(bool(torch.isfinite(flash).all()),
          "non-finite phi3.5-moe prefill logits")

    def agreement(a):
        return (float((a.float() - sdpa.float()).abs().max()),
                float((a.argmax(-1) == sdpa.argmax(-1)).float().mean()))

    # Free-running, each path routes on its own router.  The reference's
    # init gives the experts a fan-in of E, so their outputs dominate the
    # residual (rms ~100-500 against the attention's ~1): a token on a
    # near-tie of its router that one bf16 ulp of attention output moves
    # to another expert changes by O(100), and through its keys and
    # values every later token of its sequence.  Even with the expert
    # choices pinned to the sdpa run's, bf16 rounding of that residual
    # carries the difference through 16 layers.  So phase_prefill's
    # end-to-end bounds (top-1 >= 0.9, |dlogit| <= 0.5) do not apply
    # here; both comparisons are reported, and K5 is held layer by layer
    # on the main path's own inputs (check_layers_flash).
    dlogit_free, top1_free = agreement(flash)
    diverged = first_divergence(r_flash, r_sdpa, cfg.moe_top_k)
    with pinned_routes(r_sdpa):
        pinned = _prefill(model, "flash", batch)
    dlogit, top1 = agreement(pinned)
    layers = check_layers_flash(model, batch)
    out = dict(arch=cfg.name,
               layers=f"{cfg.num_layers} of {get(MOE_PHI).num_layers} "
                      "(memory)",
               d=cfg.d_model, heads=cfg.num_heads,
               kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
               experts=cfg.num_experts, top_k=cfg.moe_top_k,
               dtype=cfg.dtype, tokens=f"{PREFILL_BATCH}x{PREFILL_LEN}",
               flash_launches=launches, flash_launches_tc=launches_tc,
               max_abs_dlogit_vs_sdpa=dlogit_free,
               top1_agreement_vs_sdpa=top1_free,
               diverged_tokens=diverged["tokens"],
               diverged_at_first_layer=diverged["at_first_layer"],
               max_gap_at_first_layer=diverged["max_gap"],
               pinned_max_abs_dlogit=dlogit, pinned_top1=top1,
               layer_max_abs_err=layers["max_abs_err"],
               layer_max_abs_attn=layers["max_abs_attn"],
               first_call_s_flash=round(t_flash, 3),
               first_call_s_sdpa=round(t_sdpa, 3))
    log("moe", **out)
    check(launches == launches_tc == cfg.num_layers,
          f"{launches} flash launches ({launches_tc} on the tensor cores), "
          f"want one per layer ({cfg.num_layers}), all on the tensor cores")
    check(layers["ok"], f"phi3.5-moe: K5 vs sdpa layer by layer {layers}")
    out["reduced"] = check_moe_reduced(cfg, "flash", seed=6)
    return out


def phase_serve_moe(model) -> dict:
    """Full-width deepseek-v2-lite serves the seeded steady scenario with
    its latent cache paged through the dispersed pool."""
    from torch.profiler import ProfilerActivity, profile
    cfg = model.cfg
    scen = generate(dataclasses.replace(
        TRAFFIC_MIXES["steady"], n_requests=8, vocab=cfg.vocab_size,
        max_len=48), seed=0)
    engine = ServeEngine(cfg, model, slots=4, max_len=64, page_size=16,
                         kv_mode="dispersed", device="cuda")
    t0 = time.perf_counter()
    reqs = engine.serve(scen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in reqs)
    st = engine.kv_stats()
    out = dict(arch=cfg.name, paged="/".join(engine._paged),
               requests=len(reqs),
               done=sum(r.status == "done" for r in reqs),
               steps=len(engine.step_log), tokens_out=tokens,
               prompt_tokens=sum(len(r.prompt) for r in reqs),
               wall_s=round(wall, 3), tokens_per_s=round(tokens / wall, 2),
               hits=st["hits"], misses=st["misses"], fills=st["fills"],
               spills=st["spills"], hot_pages=st["hot_pages"],
               page_bytes=st["hot_bytes"] // st["hot_pages"])
    # Where a step's time goes: the model's decode step alone at the
    # engine's batch (CUDA events over back-to-back steps) against the
    # engine's whole step
    cache = model.init_cache(4, 64)
    step = {"tokens": torch.ones((4, 1), dtype=torch.long, device="cuda"),
            "positions": torch.full((4, 1), 8, dtype=torch.long,
                                    device="cuda")}
    out["decode_step_ms"] = cuda_ms(lambda: model.decode_step(cache, step),
                                    warmup=2, iters=5)
    out["engine_step_ms"] = wall * 1e3 / max(len(engine.step_log), 1)
    # the kernels' own device time in one decode step (torch.profiler)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.decode_step(cache, step)
        torch.cuda.synchronize()
    out["decode_step_device_ms"] = _engine_device_ms(prof, re.compile(""))
    del cache
    log("serve_moe", **out)
    check(engine._paged == ("c", "kr"),
          f"dispersed deepseek pages {engine._paged}, want ('c', 'kr')")
    check(all(r.status == "done" for r in reqs),
          f"statuses {[r.status for r in reqs]}")
    return out


def phase_moe() -> dict:
    """[moe] and [serve_moe]: deepseek-v2-lite at full width and depth,
    then phi3.5-moe at full width, each freed before the next is built.
    Returns the figures and phi3.5-moe's K5 launches."""
    out = {}
    for arch in (MOE_DEEPSEEK, MOE_PHI):
        cfg = get(arch)
        if arch == MOE_PHI:
            cfg = dataclasses.replace(cfg, num_layers=MOE_PHI_LAYERS)
        t0 = time.perf_counter()
        model = Model(cfg, device="cuda")
        model.init(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        log("model", arch=cfg.name, layers=cfg.num_layers,
            params=sum(p.numel() for p in model.parameters()),
            weight_gb=round(weight_gb(model), 3),
            build_s=round(time.perf_counter() - t0, 3))
        if arch == MOE_DEEPSEEK:
            out["deepseek"] = phase_moe_deepseek(model)
            out["serve"] = phase_serve_moe(model)
        else:
            out["phi"] = phase_moe_phi(model)
        del model
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- families --

# P5b's last four families, in the order they landed: the VLM (through
# K5), the SSM, the hybrid and the audio encoder-decoder
FAMILIES = ("qwen2-vl-7b", "falcon-mamba-7b", "recurrentgemma-2b",
            "whisper-large-v3")
VISION_TOKENS = 256         # qwen2-vl: the first 256 tokens, a 16 x 16 grid
VISION_GRID = 16
WHISPER_DEC_LEN = 448       # whisper's published decoder context
# Reduced f32 copy on the card vs the CPU, as phase_prefill's f32 check;
# decoding token by token vs the full-sequence forward, as the CPU tests
FAMILY_TOL = 1e-3
CONSISTENCY_TOL = 2e-3
# sequential decode steps of the reduced copies: the hybrid runs past its
# window of 8, so its k/v ring wraps
FAMILY_DECODE_STEPS = {"vlm": 8, "ssm": 8, "hybrid": 12, "audio": 8}
FAMILY_IMPL = {"vlm": "flash", "ssm": "sdpa", "hybrid": "sdpa",
               "audio": "flash"}
FAMILY_KV_MODE = {"vlm": "dispersed", "ssm": "resident",
                  "hybrid": "resident", "audio": "dispersed"}


def family_batch(cfg, b, s, device, seed=0, n_vision=0):
    """A prompt batch for any family, from a seed: tokens and positions;
    for M-RoPE ``positions3``, the first ``n_vision`` tokens a patch grid
    VISION_GRID wide (temporal 0, height its row, width its column) whose
    embeddings the vision stub replaces (0.02 N(0, 1), the token
    embeddings' scale), the text after counting on from the grid on all
    three sections; for whisper its encoder_seq audio frames.  Tensors
    land on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    pos = torch.arange(s).expand(b, s)
    batch = {"tokens": toks, "positions": pos}
    if cfg.positional == "mrope":
        grid = torch.arange(n_vision)
        # text counts on from the grid's larger side (rows or columns)
        start = max(-(-n_vision // VISION_GRID), min(n_vision, VISION_GRID))
        p3 = (pos - n_vision + start).expand(3, b, s).clone()
        p3[0, :, :n_vision] = 0
        p3[1, :, :n_vision] = grid // VISION_GRID
        p3[2, :, :n_vision] = grid % VISION_GRID
        batch["positions3"] = p3
        if n_vision:
            mask = torch.zeros((b, s), dtype=torch.bool)
            mask[:, :n_vision] = True
            batch["vision_mask"] = mask
            batch["vision_embeds"] = 0.02 * torch.randn(
                (b, s, cfg.d_model), generator=gen)
    if cfg.encoder_decoder:
        batch["audio_embeds"] = torch.randn(
            (b, cfg.encoder_seq, cfg.d_model), generator=gen)
    return {k: v.to(device) for k, v in batch.items()}


def _step(batch, t):
    """Token t of a prompt batch as a decode batch."""
    out = {k: batch[k][:, t:t + 1] for k in ("tokens", "positions")}
    if "positions3" in batch:
        out["positions3"] = batch["positions3"][..., t:t + 1]
    return out


def _seeded_cross(cache, seed) -> None:
    """Fill a whisper cache's encoder K/V from a seed, on the cache's
    device (nothing in the reference or the port builds them)."""
    gen = torch.Generator(device=cache["ek"].device).manual_seed(seed)
    for k in ("ek", "ev"):
        cache[k].copy_(torch.randn(cache[k].shape, generator=gen,
                                   device=cache[k].device))


def device_ops(prof) -> tuple[int, float | None]:
    """The device-side operations (kernels, copies, sets) of a profiler
    window and their summed device ms (None where none was recorded)."""
    n, us = 0, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += 1
            us += e.time_range.elapsed_us()
    return n, (us / 1e3 if n else None)


def recurrence_cost(model, batch) -> dict:
    """One recurrent layer's prefill under torch.profiler: its device
    operations (the time loop's launches) and device ms; times the
    model's recurrent layers, the whole prefill's."""
    from torch.profiler import ProfilerActivity, profile
    cfg = model.cfg
    blk = model.blocks[0]
    x = model._norm(blk.norm1, model._embed(batch))
    fn = (tssm.mamba if cfg.ssm else trglru.rglru)
    fn(blk.mixer, cfg, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(blk.mixer, cfg, x)
        torch.cuda.synchronize()
    ops_, ms = device_ops(prof)
    layers = sum(isinstance(b.mixer, (tssm.Mamba, trglru.RGLRU))
                 for b in model.blocks)
    return dict(recurrent_layers=layers, layer_device_ops=ops_,
                layer_device_ms=ms, prefill_recurrence_ops=ops_ * layers)


class CrossFilledEngine(ServeEngine):
    """A ServeEngine whose slots start with seeded encoder K/V where the
    model's cache has zeros: a stand-in for whisper's encoder output,
    which neither package's engine builds.  One draw per admission."""

    def __init__(self, *args, seed: int = 0, **kw):
        super().__init__(*args, **kw)
        self._cross_gen = torch.Generator(device=self.device).manual_seed(
            seed)

    def _reset_slot(self, s: int) -> None:
        super()._reset_slot(s)
        for k in ("ek", "ev"):
            view = self.cache[k][:, s]
            view.copy_(torch.randn(view.shape, generator=self._cross_gen,
                                   device=self.device, dtype=view.dtype))


def check_family_reduced(cfg, seed: int) -> dict:
    """A reduced f32 copy of ``cfg`` on the card (through K5 where the
    family's attention allows it) against the same weights on the CPU:
    prefill logits, then FAMILY_DECODE_STEPS sequential decode steps
    (logits, and the caches at the end) within FAMILY_TOL; the card's
    decode logits against its own prefill within CONSISTENCY_TOL (not
    for the SSM and the hybrid).  qwen2-vl prefills a vision grid and
    decodes text, whose M-RoPE positions are the slot's; whisper decodes
    against seeded encoder K/V."""
    fam = cfg.family
    impl = FAMILY_IMPL[fam]
    small = dataclasses.replace(cfg.reduced(), dtype="float32",
                                attn_impl=impl)
    m_gpu = Model(small, device="cuda")
    m_gpu.init(torch.Generator(device="cuda").manual_seed(seed))
    m_cpu = Model(small, device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in
                           m_gpu.state_dict().items()})
    steps = FAMILY_DECODE_STEPS[fam]
    sb = family_batch(small, 2, 128, "cpu", seed=seed + 1, n_vision=32)
    db = (family_batch(small, 2, steps, "cpu", seed=seed + 2)
          if small.positional == "mrope" else sb)
    fa.flash_attention_cuda.launches = 0
    got = m_gpu.prefill({k: v.cuda() for k, v in sb.items()}).cpu()
    flash = fa.flash_attention_cuda.launches
    want = m_cpu.prefill(sb)
    prefill_err = float((got - want).abs().max())

    b, smax = 2, 2 * steps
    c_gpu, c_cpu = m_gpu.init_cache(b, smax), m_cpu.init_cache(b, smax)
    if small.encoder_decoder:
        _seeded_cross(c_cpu, seed + 3)
        for k in ("ek", "ev"):
            c_gpu[k].copy_(c_cpu[k])
    recurrent = small.ssm or small.hybrid
    decode_err = consistency = 0.0
    for t in range(steps):
        step = _step(db, t)
        lg, c_gpu = m_gpu.decode_step(
            c_gpu, {k: v.cuda() for k, v in step.items()})
        lc, c_cpu = m_cpu.decode_step(c_cpu, step)
        decode_err = max(decode_err, float((lg.cpu() - lc).abs().max()))
        consistency = max(consistency,
                          float((lg[:, 0].cpu() - got[:, t]).abs().max()))
    cache_err = max(float((c_gpu[k].cpu() - c_cpu[k]).abs().max())
                    for k in c_cpu)
    out = dict(arch=cfg.name, impl=impl, flash_launches=flash,
               prefill_err=prefill_err, decode_err=decode_err,
               decode_steps=steps, cache_keys="/".join(c_cpu),
               cache_err=cache_err, tol=FAMILY_TOL)
    if recurrent:
        out.update(decode_vs_prefill=consistency,
                   consistency_tol=CONSISTENCY_TOL)
    log("families", check="reduced_f32_card_vs_cpu", **out)
    check(max(prefill_err, decode_err, cache_err) <= FAMILY_TOL,
          f"reduced {cfg.name} on the card off by {out}")
    check(not recurrent or consistency <= CONSISTENCY_TOL,
          f"reduced {cfg.name}: decode vs prefill off by {consistency}")
    check((flash > 0) == (impl == "flash"),
          f"reduced {cfg.name}: {flash} K5 launches through {impl}")
    return out


def family_prefill(model) -> dict:
    """Full-width prefill: the first call's wall and a second's, the
    logits' shape, finiteness, and the peak memory; the recurrences'
    cost for the SSM and the hybrid."""
    cfg = model.cfg
    s = WHISPER_DEC_LEN if cfg.encoder_decoder else PREFILL_LEN
    batch = family_batch(cfg, PREFILL_BATCH, s, "cuda",
                         n_vision=VISION_TOKENS)
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        logits = model.prefill(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out = dict(arch=cfg.name, tokens=f"{PREFILL_BATCH}x{s}",
               first_call_s=round(walls[0], 3),
               second_call_s=round(walls[1], 3),
               peak_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))
    if cfg.encoder_decoder:
        out["audio_frames"] = f"{PREFILL_BATCH}x{cfg.encoder_seq}"
    if cfg.ssm or cfg.hybrid:
        out.update(recurrence_cost(model, batch))
    check(logits.shape == (PREFILL_BATCH, s, cfg.vocab_size),
          f"{cfg.name} prefill logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()),
          f"non-finite {cfg.name} prefill logits")
    return out


def family_vlm_flash(model) -> dict:
    """qwen2-vl's prefill (vision stub, M-RoPE over the grid) through K5
    against the sdpa path: one launch per layer, all on the tensor
    cores, phase_prefill's bounds end to end, and K5 against sdpa layer
    by layer on the prefill's own inputs."""
    cfg = model.cfg
    batch = family_batch(cfg, PREFILL_BATCH, PREFILL_LEN, "cuda",
                         n_vision=VISION_TOKENS)
    sdpa = _prefill(model, "sdpa", batch)
    fa.flash_attention_cuda.launches = 0
    t0 = time.perf_counter()
    flash = _prefill(model, "flash", batch)
    t_flash = time.perf_counter() - t0
    launches = fa.flash_attention_cuda.launches
    launches_tc = fa.flash_attention_cuda.launches_tc
    dlogit = float((flash.float() - sdpa.float()).abs().max())
    top1 = float((flash.argmax(-1) == sdpa.argmax(-1)).float().mean())
    layers = check_layers_flash(model, batch)
    model.cfg = cfg
    out = dict(flash_launches=launches, flash_launches_tc=launches_tc,
               max_abs_dlogit_vs_sdpa=dlogit, top1_agreement_vs_sdpa=top1,
               layer_max_abs_err=layers["max_abs_err"],
               layer_max_abs_attn=layers["max_abs_attn"],
               second_call_s_flash=round(t_flash, 3))
    log("families", arch=cfg.name, check="flash_vs_sdpa", **out)
    check(launches == launches_tc == cfg.num_layers,
          f"{launches} flash launches ({launches_tc} on the tensor cores), "
          f"want one per layer ({cfg.num_layers}), all on the tensor cores")
    check(layers["ok"], f"qwen2-vl: K5 vs sdpa layer by layer {layers}")
    check(top1 >= 0.9 and dlogit <= 0.5,
          f"qwen2-vl flash vs sdpa prefill: top-1 {top1}, max |dlogit| "
          f"{dlogit}")
    return out


def family_serve(model) -> dict:
    """The seeded steady scenario cut to 8 requests: the SSM and the
    hybrid resident, qwen2-vl dispersed (k/v paged), whisper dispersed
    with its encoder K/V unpaged and seeded; then one decode step's wall
    at the engine's batch (CUDA events over back-to-back steps) and its
    device time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    cfg = model.cfg
    kv_mode = FAMILY_KV_MODE[cfg.family]
    scen = generate(dataclasses.replace(
        TRAFFIC_MIXES["steady"], n_requests=8, vocab=cfg.vocab_size,
        max_len=48), seed=0)
    kw = dict(slots=4, max_len=64, kv_mode=kv_mode, device="cuda")
    if kv_mode == "dispersed":
        kw["page_size"] = 16
    engine = (CrossFilledEngine(cfg, model, **kw) if cfg.encoder_decoder
              else ServeEngine(cfg, model, **kw))
    t0 = time.perf_counter()
    reqs = engine.serve(scen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in reqs)
    out = dict(arch=cfg.name, kv_mode=kv_mode, requests=len(reqs),
               done=sum(r.status == "done" for r in reqs),
               steps=len(engine.step_log), tokens_out=tokens,
               wall_s=round(wall, 3), tokens_per_s=round(tokens / wall, 2),
               engine_step_ms=wall * 1e3 / max(len(engine.step_log), 1))
    if kv_mode == "dispersed":
        st = engine.kv_stats()
        out.update(paged="/".join(engine._paged),
                   unpaged="/".join(engine._unpaged), hits=st["hits"],
                   misses=st["misses"], fills=st["fills"],
                   spills=st["spills"], hot_pages=st["hot_pages"])
    cache = model.init_cache(4, 64)
    if cfg.encoder_decoder:
        _seeded_cross(cache, 1)
    step = {"tokens": torch.ones((4, 1), dtype=torch.long, device="cuda"),
            "positions": torch.full((4, 1), 8, dtype=torch.long,
                                    device="cuda")}
    if cfg.positional == "mrope":
        step["positions3"] = step["positions"].expand(3, 4, 1)
    out["decode_step_ms"] = cuda_ms(lambda: model.decode_step(cache, step),
                                    warmup=2, iters=5)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.decode_step(cache, step)
        torch.cuda.synchronize()
    out["decode_step_device_ops"], out["decode_step_device_ms"] = \
        device_ops(prof)
    del cache
    log("families", check="serve", **out)
    check(all(r.status == "done" for r in reqs),
          f"{cfg.name} statuses {[r.status for r in reqs]}")
    if kv_mode == "dispersed":
        want = ("k", "v")
        check(engine._paged == want, f"dispersed {cfg.name} pages "
              f"{engine._paged}, want {want}")
    return out


def phase_families() -> dict:
    """[families]: qwen2-vl, falcon-mamba, recurrentgemma and whisper at
    their published widths and full depth, each built, seeded and freed
    before the next: prefill, qwen2-vl through K5, a reduced f32 copy on
    the card vs the CPU, and serving.  Returns the figures by family."""
    out = {}
    for arch in FAMILIES:
        cfg = get(arch)
        t0 = time.perf_counter()
        model = Model(cfg, device="cuda")
        model.init(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        fam = dict(arch=cfg.name, family=cfg.family, layers=cfg.num_layers,
                   d=cfg.d_model,
                   params=sum(p.numel() for p in model.parameters()),
                   params_counted=cfg.param_count(),
                   weight_gb=round(weight_gb(model), 3),
                   build_s=round(time.perf_counter() - t0, 3))
        if cfg.encoder_decoder:
            fam["encoder_layers"] = cfg.num_encoder_layers
        log("model", **fam)
        fam["prefill"] = family_prefill(model)
        log("families", check="prefill", **fam["prefill"])
        if cfg.family == "vlm":
            fam["flash"] = family_vlm_flash(model)
        fam["serve"] = family_serve(model)
        del model
        torch.cuda.empty_cache()
        fam["reduced"] = check_family_reduced(cfg, seed=8)
        out[cfg.family] = fam
    return out


# ----------------------------------------------------------------- serving --

SERVING_ROWS = {"kv_dispersion": 8, "serving_slo": 24}


def phase_serving() -> dict:
    """Both serving suites through repro_torch.benchmarks.run on the card:
    their row counts, serving_slo's extra (axes and Pareto fronts) equal to
    BENCH_core.json's, and kv_dispersion's rows (us_per_call aside) equal
    to the same suite with its pool on the CPU."""
    bench = json.loads((ROOT / "BENCH_core.json").read_text())["suites"]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / "serving_report.json"
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = bench_run.main(["--json", str(path)] + list(SERVING_ROWS),
                            session=api.Session())
    check(rc == 0, f"serving: run.py exited {rc}")
    report = json.loads(path.read_text())
    out = {}
    for suite, n in SERVING_ROWS.items():
        rec = report["suites"][suite]
        out[suite] = dict(rows=rec["rows"], wall_s=rec["wall_s"],
                          device=rec["device"])
        log("serving", suite=suite, **out[suite])
        check(rec["rows"] == n == bench[suite]["rows"],
              f"serving: {suite} gave {rec['rows']} rows, want {n}")
        check(rec["device"].startswith("cuda"),
              f"serving: {suite} ran on {rec['device']}")
    extra = report["suites"]["serving_slo"]["extra"]
    equal = extra == bench["serving_slo"]["extra"]
    log("serving", check="serving_slo_extra_vs_bench", equal=equal,
        fronts=sum(len(v) for f in extra["pareto"].values()
                   for v in f.values()))
    check(equal, "serving: serving_slo's extra differs from BENCH_core.json")

    def strip(rows):
        return [{k: str(v) for k, v in r.items() if k != "us_per_call"}
                for r in rows]

    card = _csv_rows(text.getvalue(), "name")
    cpu = kv_dispersion.run(device="cpu")
    equal = strip(card) == strip(cpu)
    log("serving", check="kv_dispersion_card_vs_cpu", rows=len(cpu),
        equal=equal)
    check(equal, "serving: kv_dispersion's rows on the card differ from "
          "the CPU's")
    return out


# ------------------------------------------------------------------- train --

# [train]: phi3-mini-3.8b at its published widths (bf16, seeded init),
# TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_LEN tokens, microbatches 1
TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS = 4, 256, 3
# Reduced f32 copy, one step on the card vs the CPU: loss and masters
# ------------------------------------------------------------------- adamw --

def check_adamw_plan() -> None:
    """Hold adamw.TILE against the built kernels' tile."""
    tile = fadamw.built_tile(torch.cuda.current_device())
    log("build", adamw_tile=json.dumps(tile))
    check(all(tile[k] == v for k, v in fadamw.TILE.items()),
          f"adamw: TILE {fadamw.TILE} differs from the built tile {tile}")


def _adamw_leaf(i: int, shape, dtype) -> tuple:
    """Leaf i's step inputs, the same on every call: (parameter,
    gradient, m, v, master); master N(0, 0.02), the parameter its bf16
    copy, gradients N(0, 1e-3) (a global norm of ~60, so the clip
    engages), m N(0, 1e-4), v U(0, 1e-8)."""
    gen = torch.Generator(device="cuda").manual_seed(1000 + i)
    master = torch.randn(shape, generator=gen, device="cuda") * 0.02
    grad = (torch.randn(shape, generator=gen, device="cuda")
            * 1e-3).to(dtype)
    m = torch.randn(shape, generator=gen, device="cuda") * 1e-4
    v = torch.rand(shape, generator=gen, device="cuda") * 1e-8
    return master.to(dtype, copy=True), grad, m, v, master


def _zero_adamw_counts() -> None:
    fadamw.adamw_step.launches = 0
    fadamw.adamw_cuda.launches = 0
    fadamw.adamw_cuda.uploads = 0


def _adamw_counts() -> dict:
    """Optimizer steps by route, the fused kernels' launches and the
    table's copies since the last _zero_adamw_counts."""
    return dict(fadamw.adamw_step.by_route(),
                **fadamw.adamw_cuda.by_route(),
                uploads=fadamw.adamw_cuda.uploads)


def _fused_counts(steps: int) -> dict:
    """What _adamw_counts reads after ``steps`` fused steps."""
    return dict(fused=steps, plain=0, norm=steps, update=steps,
                uploads=steps)


def phase_adamw() -> dict:
    """The fused AdamW on phi3-mini's full leaf set at full width: one
    step through the kernels held leaf by leaf to the plain twin given
    the kernels' scale, then the step timed beside its bound and the
    plain twin (module docstring, [adamw])."""
    _free()
    cfg = get(ARCH)
    shapes = {k: (tuple(p.shape), p.dtype) for k, p in
              Model(cfg, device="meta").named_parameters()}
    opt = OptConfig()
    params, grads, m, v, master = {}, {}, {}, {}, {}
    for i, (k, (shape, dtype)) in enumerate(shapes.items()):
        params[k], grads[k], m[k], v[k], master[k] = _adamw_leaf(
            i, shape, dtype)
    n = sum(p.numel() for p in params.values())
    step = torch.tensor(ADAMW_STEP, dtype=torch.int32, device="cuda")
    lr = tadamw.schedule(opt, step)
    b1c = 1 - torch.tensor(opt.b1, device="cuda") ** step.float()
    b2c = 1 - torch.tensor(opt.b2, device="cuda") ** step.float()
    check(fadamw.adamw_route(opt, params, grads, m, v, master) == "fused",
          "adamw: phi3-mini's leaves do not take the fused route")
    log("adamw", leaves=len(params), params=n,
        state_gb=round(sum(t.numel() * t.element_size() for d in (
            params, grads, m, v, master) for t in d.values()) / 1e9, 3))

    gnorm, scale = fadamw.adamw_cuda(opt, params, grads, m, v, master, lr,
                                     b1c, b2c)
    torch.cuda.synchronize()
    plain_norm = float(fadamw.global_norm(grads))
    rel = abs(float(gnorm) - plain_norm) / plain_norm
    scale_equal = torch.equal(scale, fadamw.clip_scale(gnorm,
                                                       opt.clip_norm))
    equal, first_bad, max_abs = 0, None, 0.0
    for i, (k, (shape, dtype)) in enumerate(shapes.items()):
        p0, g0, m0, v0, w0 = _adamw_leaf(i, shape, dtype)
        fadamw.update_plain(opt, {k: p0}, {k: g0}, {k: m0}, {k: v0},
                            {k: w0}, scale, lr, b1c, b2c)
        pairs = ((params[k], p0), (m[k], m0), (v[k], v0), (master[k], w0))
        same = all(torch.equal(a, b) for a, b in pairs)
        max_abs = max([max_abs] + [float((a.float() - b.float()).abs().max())
                                   for a, b in pairs])
        equal += same
        if not same and first_bad is None:
            first_bad = k
        del p0, g0, m0, v0, w0, pairs
    out = dict(leaves=len(params), params=n, equal_leaves=equal,
               max_abs_err=max_abs, grad_norm=float(gnorm),
               plain_grad_norm=plain_norm, grad_norm_rel=rel,
               scale=float(scale), scale_equal=scale_equal)
    log("adamw", check="full_leaf_set", first_unequal=first_bad, **out)
    check(equal == len(params) and scale_equal and rel <= 1e-6,
          f"adamw: {equal} of {len(params)} leaves equal the plain twin "
          f"(first unequal {first_bad}), scale equal {scale_equal}, "
          f"grad_norm {float(gnorm)} vs {plain_norm}")

    def fused_step():
        fadamw.adamw_cuda(opt, params, grads, m, v, master, lr, b1c, b2c)

    def plain_step():
        fadamw.adamw_plain(opt, params, grads, m, v, master, lr, b1c, b2c)

    # the kernels' launches and the table's copies in 3 steps, counted by
    # the wrapper, and the host's issue
    _zero_adamw_counts()
    for _ in range(3):
        fused_step()
    counts = _adamw_counts()
    check(counts == _fused_counts(3),
          f"adamw: 3 steps made {counts}, want {_fused_counts(3)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused_step()
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    samples = {"fused": [], "plain": []}
    fns = {"fused": (fused_step, 3), "plain": (plain_step, 1)}
    for r in range(ADAMW_ROUNDS):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            fn, iters = fns[name]
            samples[name].append(cuda_ms(fn, warmup=1, iters=iters))
    ms = statistics.median(samples["fused"])
    plain_ms = statistics.median(samples["plain"])
    bound = n * ADAMW_BYTES_PER_PARAM / HBM_BYTES_PER_S * 1e3
    timing = dict(ms=ms, samples_ms=samples["fused"], plain_ms=plain_ms,
                  plain_samples_ms=samples["plain"], bound_ms=bound,
                  bound_by="bytes", share_of_bound=bound / ms,
                  counts_in_3_steps=counts, host_issue_ms=issue_ms)
    log("adamw", timing="full_leaf_set", **{
        k: json.dumps(v) if isinstance(v, dict) else v
        for k, v in timing.items()})
    del params, grads, m, v, master
    _free()
    return dict(out, **timing)


TRAIN_TOL = 1e-4
# The checkpoint's directory (listed in .gitignore, removed at the end)
TRAIN_CKPT = ROOT / ".train_ckpt"
# The checkpoint round trip runs at this depth, full width: it stores 16 B
# a parameter (the bf16 params as f32, f32 m, v and master), counted
# 61.1 GB at full depth against the 45 GiB of disk a smoke run may write;
# 16 of 32 layers store 32.1 GB
TRAIN_CKPT_LAYERS = 16
# Leaves whose params and optimizer state are compared after the restore
TRAIN_HELD_LEAVES = ("embed", "blocks.0.mixer.wq", "final_norm.scale")


def _trainer(cfg, steps: int, device: str = "cuda",
             ckpt: Path = TRAIN_CKPT) -> Trainer:
    tc = TrainConfig(seq_len=TRAIN_LEN, global_batch=TRAIN_BATCH,
                     microbatches=1, steps=steps, checkpoint_every=10 ** 9,
                     checkpoint_dir=str(ckpt), seed=0, log_every=10 ** 9,
                     device=device)
    return Trainer(cfg, tc, OptConfig(warmup_steps=1,
                                      total_steps=TRAIN_STEPS + 1))


def top_device_ms(prof, n: int = 6) -> dict:
    """The ``n`` device functions of a profiler window with the most
    device time: name (cut to 48 characters) -> summed ms."""
    ms = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if us:
            ms[e.key[:48]] = ms.get(e.key[:48], 0.0) + us / 1e3
    top = sorted(ms.items(), key=lambda kv: -kv[1])[:n]
    return {k: round(v, 3) for k, v in top}


def _timed_steps(trainer, records: list, before=None) -> None:
    """Wrap the trainer's step: per step its wall (host clock around the
    step and a synchronise), its stream ms (CUDA events) and its peak
    memory; the first step, the warm-up, also runs under torch.profiler
    for its device operations and ms and its costliest device functions
    (the profiler slows the host's issue by a third, so the later steps,
    whose walls give the rates, run without it).  ``before(model, opt)``
    runs ahead of the first step."""
    from torch.profiler import ProfilerActivity, profile
    inner = trainer._step_fn

    def step(model, opt, err, batch):
        profiled = not records
        if before is not None and profiled:
            before(model, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        ctx = (profile(activities=[ProfilerActivity.CUDA]) if profiled
               else contextlib.nullcontext())
        with ctx as prof:
            # the wall leaves out the profiler's start and its teardown
            t0 = time.perf_counter()
            e0.record()
            out = inner(model, opt, err, batch)
            e1.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rec = dict(wall_s=wall, stream_ms=e0.elapsed_time(e1),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        if profiled:
            rec["device_ops"], rec["device_ms"] = device_ops(prof)
            rec["top_device_ms"] = top_device_ms(prof)
        records.append(rec)
        return out
    trainer._step_fn = step


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def train_steps(cfg) -> dict:
    """TRAIN_STEPS steps of ``cfg`` through Trainer: loss, grad norm,
    lr, wall, stream ms, peak memory (the first step's device ms from
    torch.profiler); tokens/s and 6 N tokens / step wall over the later
    steps."""
    t0 = time.perf_counter()
    tr = _trainer(cfg, TRAIN_STEPS)
    state = tr.init_state()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n = sum(p.numel() for p in tr.model.parameters())
    out = dict(arch=cfg.name, layers=cfg.num_layers, d=cfg.d_model,
               dtype=cfg.dtype, params=n, weight_gb=weight_gb(tr.model),
               opt_gb=sum(t.numel() * t.element_size() for part in (
                   "m", "v", "master") for t in state["opt"][part].values())
               / 1e9, tokens_per_step=TRAIN_BATCH * TRAIN_LEN,
               build_and_init_s=round(build_s, 3))
    log("train", **out)
    steps: list = []
    _timed_steps(tr, steps)
    _zero_adamw_counts()
    hist = tr.run(state=state)["history"]
    out["adamw_counts"] = _adamw_counts()
    log("train", adamw_counts=json.dumps(out["adamw_counts"]))
    check(out["adamw_counts"] == _fused_counts(len(hist)),
          f"train: the optimizer's {len(hist)} steps made "
          f"{out['adamw_counts']}, want {_fused_counts(len(hist))}")
    for h, s in zip(hist, steps):
        log("train", step=h["step"], loss=h["loss"],
            grad_norm=h["grad_norm"], lr=h["lr"], **s)
        check(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]),
              f"train: step {h['step']} loss {h['loss']} grad_norm "
              f"{h['grad_norm']}")
    check(len(hist) == TRAIN_STEPS, f"train: {len(hist)} steps")
    wall = statistics.median(s["wall_s"] for s in steps[1:])
    out.update(steps=[dict(h, **s) for h, s in zip(hist, steps)],
               step_wall_s=wall,
               tokens_per_s=out["tokens_per_step"] / wall,
               tflops=6 * n * out["tokens_per_step"] / wall / 1e12,
               peak_gb=max(s["peak_gb"] for s in steps))
    del tr, state
    _free()
    return out


def checkpoint_roundtrip(cfg) -> dict:
    """TRAIN_STEPS steps of ``cfg``, a checkpoint of its params and
    optimizer state, then a fresh Trainer that restores it (held leaf by
    leaf) and takes one more step."""
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    tr = _trainer(cfg, TRAIN_STEPS)
    state = tr.init_state()
    tr.run(state=state)
    like = {"params": state["params"], "opt": state["opt"]}
    ckpt_bytes = sum(t.numel() * 4 for part in (
        like["params"], like["opt"]["m"], like["opt"]["v"],
        like["opt"]["master"]) for t in part.values())
    free_bytes = shutil.disk_usage(ROOT).free
    check(free_bytes > 1.1 * ckpt_bytes, f"train: {free_bytes} bytes free "
          f"on disk, the checkpoint needs {ckpt_bytes}")
    held = {k: [like["params"][k].detach().cpu()]
            + [like["opt"][part][k].cpu() for part in ("m", "v", "master")]
            for k in TRAIN_HELD_LEAVES}
    t0 = time.perf_counter()
    tr.ckpt.save(TRAIN_STEPS, like)
    snapshot_s = time.perf_counter() - t0
    tr.ckpt.wait()
    out = dict(layers=cfg.num_layers, checkpoint_gb=ckpt_bytes / 1e9,
               snapshot_s=round(snapshot_s, 3),
               save_s=round(time.perf_counter() - t0, 3))
    log("train", check="checkpoint", **out)
    del tr, state, like
    _free()

    def held_equal(model, opt):
        params = dict(model.named_parameters())
        for k, (p, m, v, master) in held.items():
            check(all(torch.equal(a.cpu(), b) for a, b in (
                (params[k].detach(), p), (opt["m"][k], m),
                (opt["v"][k], v), (opt["master"][k], master))),
                f"train: {k} differs after the restore")
        check(int(opt["step"]) == TRAIN_STEPS,
              f"train: restored step {int(opt['step'])}")

    t0 = time.perf_counter()
    tr = _trainer(cfg, TRAIN_STEPS + 1)
    steps: list = []
    _timed_steps(tr, steps, before=held_equal)
    hist = tr.run()["history"]
    check([h["step"] for h in hist] == [TRAIN_STEPS],
          f"train: the restored run took steps {[h['step'] for h in hist]}")
    check(np.isfinite(hist[0]["loss"]),
          f"train: restored step loss {hist[0]['loss']}")
    out["restored"] = dict(hist[0], **steps[0], held=len(held) * 4,
                           init_restore_and_step_s=round(
                               time.perf_counter() - t0, 3))
    log("train", check="restored", restored_from=TRAIN_STEPS,
        **out["restored"])
    del tr
    _free()
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    return out


def check_train_reduced() -> dict:
    """A reduced f32 phi3-mini, one Trainer step on the card and the same
    step, weights and batch on the CPU: loss and updated masters within
    TRAIN_TOL."""
    cfg = dataclasses.replace(get(ARCH).reduced(), dtype="float32")
    cpu = _trainer(cfg, 1, "cpu", TRAIN_CKPT / "reduced")
    gpu = _trainer(cfg, 1, "cuda", TRAIN_CKPT / "reduced")
    s_cpu = cpu.init_state()
    gpu.model.load_state_dict(cpu.model.state_dict())
    opt = tadamw.init_state(dict(gpu.model.named_parameters()))
    batch = cpu._make_batch(0)
    _, o_cpu, _, m_cpu = cpu._step_fn(cpu.model, s_cpu["opt"], None, batch)
    _, o_gpu, _, m_gpu = gpu._step_fn(
        gpu.model, opt, None, {k: v.cuda() for k, v in batch.items()})
    loss_err = abs(float(m_gpu["loss"]) - float(m_cpu["loss"]))
    master_err = max(float((o_gpu["master"][k].cpu() - w).abs().max())
                     for k, w in o_cpu["master"].items())
    out = dict(check="reduced_f32_card_vs_cpu", loss=float(m_cpu["loss"]),
               loss_err=loss_err, master_err=master_err,
               grad_norm=float(m_cpu["grad_norm"]),
               grad_norm_card=float(m_gpu["grad_norm"]))
    log("train", **out)
    check(loss_err <= TRAIN_TOL and master_err <= TRAIN_TOL,
          f"train: reduced f32 card vs CPU loss {loss_err}, masters "
          f"{master_err}")
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    return out


def phase_train(card: str) -> dict:
    """The training path (P7a) on the card: train_steps at full depth
    (its measured peak, 62.8 GB on an "NVIDIA H100 80GB HBM3, 700.00 W",
    fits), the checkpoint round trip at
    TRAIN_CKPT_LAYERS layers, then the reduced f32 check.  Writes its
    figures to chiprun_out/train.json.  ``card`` is nvidia-smi's name
    and power limit, printed beside the rates."""
    cfg = get(ARCH)
    _free()
    t0 = time.perf_counter()
    out = train_steps(cfg)
    log("train", step_wall_s=out["step_wall_s"],
        tokens_per_s=out["tokens_per_s"], achieved_tflops=out["tflops"],
        peak_gb=out["peak_gb"], card=card)
    log("train", checkpoint_depth_cut=f"{TRAIN_CKPT_LAYERS} of "
        f"{cfg.num_layers} layers")
    out["checkpoint"] = checkpoint_roundtrip(
        dataclasses.replace(cfg, num_layers=TRAIN_CKPT_LAYERS))
    out["reduced"] = check_train_reduced()
    out["seconds"] = round(time.perf_counter() - t0, 2)
    log("train", seconds=out["seconds"])
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "train.json").write_text(json.dumps(dict(out, card=card),
                                                   indent=1))
    return out


# ------------------------------------------------------------------- shard --

# [shard] (P7b): a 1 x 1 ("data", "model") mesh over NCCL on the card
SHARD_DECODE_STEPS = 8
SHARD_TRAIN_LAYERS = 8                 # of phi3-mini's 32, at full width
SHARD_TRAIN_BATCH, SHARD_TRAIN_LEN = 4, 512
SHARD_TOL_LOSS = 1e-5                  # relative, the reference's test
SHARD_TOL_MASTER = 1e-5
# The production plan in the phase: the 10 archs at these shapes on the
# 16 x 16 mesh (the whole sweep takes several minutes of host time; it
# runs as its own command), on the host while the card runs the rest
DRYRUN_SHAPES = ("train_4k", "decode_32k")
DRYRUN_JOBS = 3                        # per shape: 6 of the host's cores
DRYRUN_TIMEOUT_S = 400


def _start_group(device: str, tmp: Path) -> None:
    """A one-rank process group: NCCL on the card, gloo on the CPU."""
    import torch.distributed as dist
    tmp.mkdir(parents=True, exist_ok=True)
    store = tmp / "store"
    if store.exists():
        store.unlink()
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{store}", rank=0,
                            world_size=1)


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _zero_flash(device: str) -> None:
    if device == "cuda":
        fa.flash_attention_cuda.launches = 0
    else:
        fa.flash_attention_plain.calls = 0


def _flash_count(device: str) -> int:
    return (fa.flash_attention_cuda.launches if device == "cuda"
            else fa.flash_attention_plain.calls)


def _greedy(model, first, steps: int, mesh=None):
    """``steps`` greedy decode steps from the tokens ``first`` (B, 1),
    with the cache and batch placed on ``mesh`` when one is given."""
    from repro_torch.launch import sharding as shr
    from repro_torch.models import common
    b = first.shape[0]
    cache = model.init_cache(b, steps)
    if mesh is not None:
        cache = shr.place_tree(cache, shr.cache_shardings(cache, mesh))
    tok, out = first, []
    with common.mesh_context(mesh):
        for t in range(steps):
            batch = {"tokens": tok, "positions": torch.full(
                (b, 1), t, dtype=torch.long, device=first.device)}
            if mesh is not None:
                batch = shr.place_tree(batch, shr.batch_shardings(
                    batch, mesh, "decode"))
            logits, cache = model.decode_step(cache, batch)
            tok = _whole(logits)[:, -1].argmax(-1, keepdim=True)
            out.append(tok)
    return torch.cat(out, 1)


def shard_serve(mesh, device: str = "cuda", cfg=None) -> dict:
    """Full phi3-mini through flash: the prefill and SHARD_DECODE_STEPS
    greedy decode steps unsharded, then the same model's parameters
    placed on ``mesh`` and both again; the mesh prefill's K5 calls are
    counted (one per layer, through local_map)."""
    from repro_torch.launch import sharding as shr
    from repro_torch.models import common
    cfg = dataclasses.replace(cfg or get(ARCH), attn_impl="flash")
    with torch.no_grad():
        model = Model(cfg, device=device)
        model.init(torch.Generator(device=device).manual_seed(0))
        batch = _prompt_batch(cfg, PREFILL_BATCH, PREFILL_LEN, device)
        want = model.prefill(batch)
        want_tokens = _greedy(model, batch["tokens"][:, :1],
                              SHARD_DECODE_STEPS)
        shr.distribute_model(model, shr.params_shardings(
            dict(model.named_parameters()), mesh, cfg))
        placed = shr.place_tree(batch, shr.batch_shardings(batch, mesh,
                                                           "prefill"))
        _zero_flash(device)
        with common.mesh_context(mesh):
            got = _whole(model.prefill(placed))
        launches = _flash_count(device)
        got_tokens = _greedy(model, batch["tokens"][:, :1],
                             SHARD_DECODE_STEPS, mesh)
    max_abs = float((got.float() - want.float()).abs().max())
    out = dict(launches=launches, layers=cfg.num_layers,
               prefill_equal=bool(torch.equal(got, want)),
               prefill_max_abs=max_abs,
               tokens_equal=bool(torch.equal(got_tokens, want_tokens)),
               tokens=got_tokens.tolist())
    del model, want, got
    return out


def _train_batch(cfg, device):
    batch = _prompt_batch(cfg, SHARD_TRAIN_BATCH, SHARD_TRAIN_LEN, device,
                          seed=5)
    batch["targets"] = torch.roll(batch["tokens"], -1, dims=1)
    return batch


def shard_train(mesh, device: str = "cuda", cfg=None) -> dict:
    """One train step of phi3-mini at full width and SHARD_TRAIN_LAYERS
    layers, unsharded, then on ``mesh`` from the same weights under
    FlopCounterMode: the losses, the updated f32 masters, the sharded
    step's FLOPs and its peak memory (the state and the step alone)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import sharding as shr
    from repro_torch.models import common
    from repro_torch.train.train_step import make_train_step
    cfg = cfg or dataclasses.replace(get(ARCH),
                                     num_layers=SHARD_TRAIN_LAYERS)
    model = Model(cfg, device=device)
    model.init(torch.Generator(device=device).manual_seed(1))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batch = _train_batch(cfg, device)
    step = make_train_step(cfg, OptConfig(), 1)
    opt = tadamw.init_state(dict(model.named_parameters()))
    _zero_adamw_counts()
    _, opt, _, met = step(model, opt, None, batch)
    unsharded_counts = _adamw_counts()
    want_loss = float(met["loss"])
    want_masters = {k: v.cpu() for k, v in opt["master"].items()}
    del opt, met
    with torch.no_grad():
        model.load_state_dict(init)
    del init
    shr.distribute_model(model, shr.params_shardings(
        dict(model.named_parameters()), mesh, cfg))
    placed = shr.place_tree(batch, shr.batch_shardings(batch, mesh,
                                                       "train"))
    _free()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with common.mesh_context(mesh):
        opt = tadamw.init_state(dict(model.named_parameters()))
        _zero_adamw_counts()
        with FlopCounterMode(display=False) as counter:
            _, opt, _, met = step(model, opt, None, placed)
        sharded_counts = _adamw_counts()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    loss = float(_whole(met["loss"]))
    master_err = max(float((_whole(v).cpu() - want_masters[k]).abs().max())
                     for k, v in opt["master"].items())
    out = dict(loss=loss, want_loss=want_loss,
               loss_rel_err=abs(loss - want_loss) / abs(want_loss),
               master_max_abs_err=master_err,
               adamw_counts=dict(unsharded=unsharded_counts,
                                 sharded=sharded_counts),
               flops=counter.get_total_flops(),
               max_memory_allocated=peak)
    del model, opt, met, placed
    _free()
    return out


def plan_cell(arch_cfg, shape, mesh_shape, microbatches=1) -> dict:
    """launch.dryrun's plan of one cell, in a process of its own (the fake
    process group is process-wide); ``arch_cfg`` is registered for it."""
    code = textwrap.dedent(f"""
        import dataclasses, json
        import repro_torch.configs.registry as reg
        from repro_torch.configs import ArchConfig
        from repro_torch.configs.registry import ShapeConfig
        from repro_torch.launch import dryrun
        cfg = ArchConfig(**json.loads({json.dumps(json.dumps(
            dataclasses.asdict(arch_cfg)))}))
        reg.ARCHS[cfg.name] = cfg
        shape = ShapeConfig(**json.loads({json.dumps(json.dumps(
            dataclasses.asdict(shape)))}))
        print(json.dumps(dryrun.run_cell(
            cfg.name, shape, mesh_shape={tuple(mesh_shape)},
            microbatches={microbatches}, verbose=False)))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    check(res.returncode == 0, f"plan of {arch_cfg.name}: "
          f"{res.stderr[-2000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def start_production_plan(out_dir: Path) -> list:
    """launch.dryrun over the 10 archs at DRYRUN_SHAPES on the 16 x 16
    mesh, started in the background (host CPU only): one process per
    shape, DRYRUN_JOBS cells at once in each."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for shape in DRYRUN_SHAPES:
        path = out_dir / f"dryrun_phase_{shape}.json"
        procs.append((shape, path, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--mesh", "single", "--jobs", str(DRYRUN_JOBS), "--shape",
             shape, "--out", str(path)], cwd=ROOT, env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            start_new_session=True)))
    return procs


def stop_production_plan(procs) -> None:
    """Kill what is left of the plan's processes and their workers."""
    import signal
    for _, _, proc in procs:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def finish_production_plan(procs, t0: float) -> list:
    """Wait for the plan's processes: one [dryrun] line per cell."""
    from repro_torch.configs import ARCHS
    cells = []
    for shape, path, proc in procs:
        _, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        check(proc.returncode == 0, f"dryrun --shape {shape}: "
              f"{err[-2000:]}")
        cells += json.loads(path.read_text())
    for c in cells:
        coll = c.get("collectives", {}).get("collective_bytes")
        log("dryrun", cell=f"{c['arch']}/{c['shape']}", status=c["status"],
            flops=c.get("flops"), coll_bytes=coll,
            bytes_per_device=c.get("bytes_per_device"),
            fits_80g=c.get("fits_80g"),
            plan_s=round(c.get("lower_s", 0) + c.get("compile_s", 0), 1))
    bad = [(c["arch"], c["shape"]) for c in cells if c["status"] != "ok"]
    check(len(cells) == len(ARCHS) * len(DRYRUN_SHAPES) and not bad,
          f"production plan: {len(cells)} cells, not ok: {bad}")
    log("dryrun", cells=len(cells), mesh="16x16",
        seconds=round(time.perf_counter() - t0, 1))
    return cells


def phase_shard(card: str) -> dict:
    """[shard] (P7b) on the card: the 1 x 1 mesh's prefill (K5 through
    local_map), decode and train step held to their unsharded runs; the
    plan of that train step held to its real FLOPs and memory; the
    production plan's cells.  Writes chiprun_out/shard.json."""
    import torch.distributed as dist

    from repro_torch.configs.registry import ShapeConfig
    from repro_torch.launch import analytic
    from repro_torch.launch.mesh import make_debug_mesh
    t0 = time.perf_counter()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    procs = start_production_plan(out_dir)
    try:
        _start_group("cuda", out_dir / "shard_group")
        try:
            mesh = make_debug_mesh(1, 1)
            serve = shard_serve(mesh)
            log("shard", check="prefill_flash_local_map", mesh="1x1",
                equal=serve["prefill_equal"], max_abs=serve["prefill_max_abs"],
                k5_launches=serve["launches"], want_launches=serve["layers"])
            log("shard", check="decode", steps=SHARD_DECODE_STEPS,
                equal=serve["tokens_equal"])
            _free()
            train = shard_train(mesh)
            log("shard", check="train_step", layers=SHARD_TRAIN_LAYERS,
                equal=train["loss"] == train["want_loss"],
                max_abs=train["master_max_abs_err"],
                loss=train["loss"], want_loss=train["want_loss"],
                loss_rel_err=train["loss_rel_err"],
                adamw_counts=json.dumps(train["adamw_counts"]))
        finally:
            dist.destroy_process_group()
        check(serve["launches"] == serve["layers"],
              f"shard: {serve['launches']} K5 launches under the mesh, want "
              f"one per layer ({serve['layers']})")
        # one card: every op is the unsharded one on the whole tensor
        check(serve["prefill_max_abs"] <= 1e-2 and serve["tokens_equal"],
              f"shard: prefill off by {serve['prefill_max_abs']}, tokens "
              f"equal {serve['tokens_equal']}")
        check(train["loss_rel_err"] <= SHARD_TOL_LOSS
              and train["master_max_abs_err"] <= SHARD_TOL_MASTER,
              f"shard: train step {train}")
        check(train["adamw_counts"] == dict(unsharded=_fused_counts(1),
                                            sharded=_fused_counts(1)),
              f"shard: optimizer steps {train['adamw_counts']}, want one "
              "fused step each")

        cfg8 = dataclasses.replace(get(ARCH), num_layers=SHARD_TRAIN_LAYERS,
                                   name=f"{ARCH}-{SHARD_TRAIN_LAYERS}l")
        shape = ShapeConfig("shard_train", SHARD_TRAIN_LEN, SHARD_TRAIN_BATCH,
                            "train")
        plan = plan_cell(cfg8, shape, (1, 1))
        model_flops = analytic.model_flops(cfg8, shape)["model_flops"]
        log("shard", check="plan_vs_real", plan_flops=plan["flops"],
            real_flops=train["flops"], equal=plan["flops"] == train["flops"],
            analytic_model_flops=model_flops,
            plan_over_analytic=plan["flops"] / model_flops,
            plan_bytes_per_device=plan["bytes_per_device"],
            max_memory_allocated=train["max_memory_allocated"],
            plan_over_real_memory=plan["bytes_per_device"]
            / train["max_memory_allocated"], plan_s=plan["compile_s"],
            card=card)
        check(plan["status"] == "ok" and plan["flops"] == train["flops"],
              f"shard: the plan counts {plan['flops']} FLOPs, the real step "
              f"{train['flops']}")
        cells = finish_production_plan(procs, t0)
    finally:
        stop_production_plan(procs)
    out = dict(serve=serve, train=train, plan=plan, cells=cells,
               card=card, seconds=round(time.perf_counter() - t0, 2))
    log("shard", seconds=out["seconds"])
    (out_dir / "shard.json").write_text(json.dumps(out, indent=1))
    return out


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
    its launches on the engine's paper path, in the [paper] phase's
    suites, the [cluster] and [network] phases (the values each held to
    BENCH_core.json, and each suite's figures), the largest |kernel -
    plain| of its checks, its device time, bound and longest chain at the
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
        launches=sum(engine["launches_by_path"][name].values()),
        launches_by_path=engine["launches_by_path"][name],
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
        held_to_bench=(engine["held"] + engine["paper"]["held"]
                       + engine["network"]["held"]),
        timing=engine["timing"], paper_suites=engine["paper"]["suites"],
        network_suite=engine["network"])


def cluster_entry(cluster) -> dict:
    """The kernels line's record of K2: its launches in the [cluster]
    main path (the two suites at paper size, the values they held to
    BENCH_core.json, each suite's figures), the largest |kernel - plain|
    of its checks, its device time, bound and longest chain (the
    requests of its largest (lane, L2 set) bucket) on cluster_sweep's 4 KB
    grid, and its plain version's host time where its own time was also
    taken: the reduced check's inputs."""
    t, r = cluster["timing"], cluster["reduced"]
    return dict(
        name="cluster_l2", route="cuda",
        source="src/repro_torch/kernels/csrc/cluster_scan.cu",
        replaces="src/repro/cluster/engine.py:74",
        launches=cluster["launches"]["cluster_l2"],
        launches_by_path={"cluster": cluster["launches"]["cluster_l2"]},
        max_abs_err=max([r["max_abs_err"]] + [
            c["max_abs_err"] for c in cluster["paper_cut"].values()]),
        timing_input="cluster_sweep_4kb_folded", ms=t["ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        chain="requests of the largest (lane, L2 set) bucket",
        chain_steps=t["largest_bucket"],
        ns_per_chain_step=t["ns_per_chain_step"],
        plain_ms=r["k2_plain_ms"], plain_device="cpu",
        plain_inputs=dict(programs=r["programs"], rows=r["rows"],
                          clusters=r["clusters"], k2_lanes=r["k2_lanes"]),
        ms_at_plain_inputs=r["k2_ms"], library_ms=None,
        held_to_bench=cluster["held"], timing=t,
        cluster_suites=cluster["suites"])


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
    for entry in ptxas_summary(logs["cluster_scan"], "cluster_"):
        log("build", **entry)
    adamw_build = ptxas_summary(logs["adamw"], "adamw")
    for entry in adamw_build:
        log("build", **entry)
    check(not logs["adamw"] or (len(adamw_build) == 2 and not any(
        e["spill_stores"] or e["spill_loads"] for e in adamw_build)),
        f"adamw: the build spills or lacks a kernel: {adamw_build}")
    check_tc_plan()
    check_flash_plan()
    check_norm_plan()
    check_engine_plan()
    check_cluster_plan()
    check_adamw_plan()

    flash_err = phase_kernels()
    gemm_errs = phase_gemm_kernels()
    norm_err, norm_held = phase_norm_kernels()
    engine_twin = phase_engine_twin()
    session = api.Session()
    programs = phase_trace(session)
    engine = phase_engine(session, programs)
    del programs
    for fn in ENGINE_KERNELS.values():
        fn.launches = 0
    paper = phase_paper(session)
    paper_launches = {name: fn.launches
                      for name, fn in ENGINE_KERNELS.items()}
    check(all(paper_launches.values()) and paper_launches == paper[
        "launches"], f"paper: K1 launches {paper_launches}, the report's "
          f"{paper['launches']}")
    cluster = phase_cluster(session)
    del session
    # [network] registers the bridge's net:* kernels, so it runs after
    # every phase that walks the rvv registry
    network = phase_network()
    engine["launches_by_path"] = {
        name: {"engine": engine["launches"][name],
               "paper": paper_launches[name],
               "cluster": cluster["launches"][name],
               "network": network["launches"][name]}
        for name in ENGINE_KERNELS}
    engine["paper"] = paper
    engine["network"] = network

    # The models' parameters are trainable; every phase before [train]
    # runs them forward only
    with torch.no_grad():
        cfg = get(ARCH)
        model = Model(cfg, device="cuda")
        model.init(torch.Generator(device="cuda").manual_seed(0))
        log("model", arch=cfg.name, params=sum(
            p.numel() for p in model.parameters()),
            weight_gb=round(weight_gb(model), 3))
        prefill_launches = phase_prefill(model)
        model.cfg = cfg
        phase_serve(model)
        del model
        torch.cuda.empty_cache()
        moe = phase_moe()
        moe_launches = moe["phi"]["flash_launches"]
        families = phase_families()
        vlm_launches = families["vlm"]["flash"]["flash_launches"]
        phase_serving()
        paths = phase_roofline()
        flash_timing = phase_timing()
        gemm = phase_gemm_timing()
        norm = phase_norm_timing()
        adamw_timing = phase_adamw()
    train = phase_train(smi)
    shard = phase_shard(smi)
    shard_launches = shard["serve"]["launches"]

    def launches(name, extra=None):
        by_path = {p: n[name] for p, n in paths.items() if n[name]}
        by_path.update(extra or {})
        return dict(launches=sum(by_path.values()), launches_by_path=by_path)

    route_launches = roofline.perf_stats()["route_launches"]
    flash_routes = {route: sum(r[route] for r in route_launches[
        "flash_attention"].values()) for route in ("tc", "fma")}
    # all on the tensor cores
    flash_routes["tc"] += (prefill_launches + moe_launches + vlm_launches
                           + shard_launches)

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
             **launches("flash_attention", {"prefill": prefill_launches,
                                            "prefill_moe": moe_launches,
                                            "prefill_vlm": vlm_launches,
                                            "prefill_shard": shard_launches}),
             launches_by_route=flash_routes,
             # under a DeviceMesh K5 runs on each rank's local shard
             mesh_route=dict(via="local_map", mesh="1x1",
                             launches=shard_launches),
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
        cluster_entry(cluster),
        # the optimizer's fused step replaces no TPU kernel; the launches
        # are the main path's, [train]'s Trainer steps (steps by route,
        # launches by kernel, the table's copies); [shard]'s unsharded
        # and sharded steps beside them
        dict(name="adamw", route="cuda",
             source="src/repro_torch/kernels/csrc/adamw.cu",
             replaces="none (src/repro/optim/adamw.py apply_updates is "
                      "plain jnp)",
             launches=train["adamw_counts"]["norm"]
             + train["adamw_counts"]["update"],
             launches_by_route=train["adamw_counts"],
             shard_launches_by_route=shard["train"]["adamw_counts"],
             shape=[adamw_timing["leaves"], adamw_timing["params"]],
             dtype="bfloat16",
             **{k: adamw_timing[k] for k in (
                 "max_abs_err", "ms", "bound_ms", "bound_by", "plain_ms",
                 "grad_norm_rel", "counts_in_3_steps", "host_issue_ms")}),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
