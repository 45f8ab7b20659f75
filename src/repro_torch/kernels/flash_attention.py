"""FlashAttention-2 forward: the CUDA kernel, its wrapper and its plain twin.

Port of the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, body ``_flash_kernel``).  On the TPU the running max,
normaliser and output accumulator live in VMEM scratch and K/V stream
through it block by block; on Hopper one CTA per (batch*head, query tile)
keeps them in registers and loops over K/V tiles staged in shared memory
(``csrc/flash_attention.cu``, which also says what bounds it).

Dispatch is by the device of the tensors: a CPU tensor goes to
:func:`flash_attention_plain`, a CUDA tensor to the kernel, which launches
or raises.  ``block_q``/``block_k`` are validated as the reference does
(same ``ValueError``s) and otherwise unused: the CUDA tile is the kernel's
own choice.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 96, 128)       # instantiated in the CUDA source
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_blocks(sq: int, sk: int, *, block_q: int, block_k: int):
    """Clamp blocks to the sequence lengths, then require exact tiling —
    raising ``ValueError``s that name the offending dimension instead of
    bare asserts (which vanish under ``python -O``)."""
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    if sq % block_q:
        raise ValueError(
            f"query length sq={sq} is not divisible by block_q={block_q}; "
            f"legal block_q values divide sq (e.g. "
            f"{[d for d in (32, 64, 128, 256) if sq % d == 0]})")
    if sk % block_k:
        raise ValueError(
            f"key length sk={sk} is not divisible by block_k={block_k}; "
            f"legal block_k values divide sk (e.g. "
            f"{[d for d in (32, 64, 128, 256) if sk % d == 0]})")
    return block_q, block_k, sq // block_q, sk // block_k


def flash_attention_plain(q, k, v, *, causal: bool = False,
                          scale: float | None = None):
    """Plain-torch attention with the kernel's semantics: f32 scores, the
    top-left causal rule (row i sees columns j <= i) with the finite
    NEG_INF, output cast to q's dtype.  k/v may have fewer heads than q
    (GQA, q heads a multiple).  The CPU path and the kernel's oracle."""
    sq, d = q.shape[-2], q.shape[-1]
    sk = k.shape[-2]
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    if scale is None:
        scale = float(d) ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(rows < cols, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out.to(q.dtype)


def flash_attention_cuda(q, k, v, *, causal: bool, scale: float):
    """Launch the CUDA kernel on CUDA tensors q (B, Hq, Sq, D) and k/v
    (B, Hkv, Sk, D), Hq a multiple of Hkv, each with a unit stride along D.
    The output has q's strides.  Raises on anything the kernel does not
    take and on a failed launch; never falls back."""
    from repro_torch.kernels import _build

    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention_cuda takes float32 or bfloat16, "
                         f"all alike; got {q.dtype}, {k.dtype}, {v.dtype}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, sk, d) or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; have {HEAD_DIMS}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"q heads ({hq}) must be a multiple of k/v heads "
                         f"({hkv})")
    if b * hq > 65535:
        raise ValueError(f"batch*heads={b * hq} exceeds the grid limit")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a unit stride along the head dim")
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_int64] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, hq, hkv, sq, sk, d, *strides, float(scale), int(causal),
                 _DTYPE_CODE[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def _attend(q, k, v, *, causal: bool, scale: float | None):
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None, block_q: int = 128,
                    block_k: int = 128):
    """q,k,v: (B, H, S, D) with equal H (``ops.flash_attention`` takes
    GQA).  Returns q's shape and dtype."""
    h = q.shape[1]
    if k.shape[1] != h:
        raise ValueError(
            f"flash_attention needs equal head counts, got q heads={h} vs "
            f"k/v heads={k.shape[1]} (use ops.flash_attention for GQA)")
    _check_blocks(q.shape[2], k.shape[2], block_q=block_q, block_k=block_k)
    return _attend(q, k, v, causal=causal, scale=scale)
