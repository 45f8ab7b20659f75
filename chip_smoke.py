"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

  1. build     compile every CUDA kernel of the port from src/ (nvcc,
               sm_90a), all sources at once;
  2. kernels   hold each kernel against its plain-torch twin on the card at
               the main path's shapes and a few edge shapes;
  3. prefill   full-width phi3-mini-3.8b (random weights from a seeded
               generator): Model.prefill on 4 x 512 tokens with the flash
               kernel vs the plain sdpa path, counting kernel launches, and
               a reduced f32 model on the card vs the same on the CPU;
  4. serve     a ServeEngine with dispersed KV pages answers a seeded
               steady-traffic scenario at full width;
  5. timing    each kernel at its prefill shape beside its bound, its plain
               twin and the library call computing the same function.

The last lines are the kernels' JSON record, the card's name and power
limit, and the result line {"ok": true, "device": {...}}.  Without a CUDA
device the script prints no result and exits 1.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import TRAFFIC_MIXES, ServeEngine, generate  # noqa: E402

ARCH = "phi3-mini-3.8b"
PREFILL_BATCH, PREFILL_LEN = 4, 512
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,          # dense tensor-core bf16
              torch.float32: 67e12}            # FP32 outside tensor cores
# Kernel vs plain twin on the card.  f32: same arithmetic, other summation
# order and exp implementation over up to 512 terms.  bf16: both accumulate
# in f32 and round the output once, so they differ by about one bf16 ulp.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


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

def _qkv(gen, q_shape, kv_shape, dtype, *, bshd=False):
    """Random q, k, v on the card; ``bshd`` makes them (B,S,H,D) tensors
    viewed as (B,H,S,D), the strided layout the model's prefill passes."""
    def one(shape):
        if bshd:
            b, h, s, d = shape
            return torch.randn((b, s, h, d), generator=gen, device="cuda",
                               dtype=dtype).transpose(1, 2)
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
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
    """K5 against its plain twin; returns the max |err| at the prefill
    shape."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # (name, q shape, kv shape, dtype, causal, bshd)
        ("prefill", (4, 32, 512, 96), (4, 32, 512, 96), torch.bfloat16,
         True, True),
        ("f32_causal", (2, 8, 384, 96), (2, 8, 384, 96), torch.float32,
         True, False),
        ("f32_full", (2, 8, 384, 96), (2, 8, 384, 96), torch.float32,
         False, False),
        ("gqa_32_8_d128", (2, 32, 256, 128), (2, 8, 256, 128),
         torch.bfloat16, True, False),
        ("ragged_sq_ne_sk", (1, 8, 200, 64), (1, 8, 328, 64), torch.float32,
         False, False),
    ]
    prefill_err = None
    for name, qs, ks, dtype, causal, bshd in cases:
        q, k, v = _qkv(gen, qs, ks, dtype, bshd=bshd)
        got = ops.flash_attention(q, k, v, causal=causal, block_q=qs[2],
                                  block_k=ks[2])
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        atol, rtol = TOL[dtype]
        err = (got.float() - want.float()).abs()
        ok = bool((err <= atol + rtol * want.float().abs()).all())
        log("kernels", case=name, q=list(qs), kv=list(ks),
            dtype=str(dtype).split(".")[-1], causal=causal,
            max_abs_err=float(err.max()), atol=atol, rtol=rtol, ok=ok)
        check(ok and bool(torch.isfinite(got).all()),
              f"flash_attention disagrees with its plain twin on {name}")
        if name == "prefill":
            prefill_err = float(err.max())
    return prefill_err


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
        flash_launches=launches, max_abs_dlogit_vs_sdpa=dlogit,
        top1_agreement_vs_sdpa=top1, first_call_s_flash=round(t_flash, 3),
        first_call_s_sdpa=round(t_sdpa, 3))
    check(launches == cfg.num_layers,
          f"{launches} flash launches, want one per layer "
          f"({cfg.num_layers})")
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


# ------------------------------------------------------------------ timing --

def phase_timing() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(4)
    shape = (PREFILL_BATCH, 32, PREFILL_LEN, 96)
    q, k, v = _qkv(gen, shape, shape, torch.bfloat16, bshd=True)
    ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True))
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                        causal=True))
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    bound_ms, bound_by = attention_bound_ms(q, k, v, causal=True)
    log("timing", kernel="flash_attention", shape=list(shape),
        dtype="bfloat16", causal=True, ms=ms, plain_ms=plain_ms,
        sdpa_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
        share_of_bound=bound_ms / ms)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)


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
                                       "spill")):
                print(f"[build] {name}: {line.strip()}")
    log("build", kernels=sorted(logs), seconds=round(
        time.perf_counter() - t0, 2))

    prefill_err = phase_kernels()

    cfg = get(ARCH)
    model = Model(cfg, device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(0))
    log("model", arch=cfg.name, params=sum(p.numel()
                                           for p in model.parameters()),
        weight_gb=round(sum(p.numel() * p.element_size()
                            for p in model.parameters()) / 1e9, 3))
    launches = phase_prefill(model)
    model.cfg = cfg
    phase_serve(model)
    timing = phase_timing()

    kernels = [dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:118",
        launches=launches, max_abs_err=prefill_err, **timing)]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
