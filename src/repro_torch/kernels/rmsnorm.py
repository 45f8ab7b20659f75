"""Fused RMSNorm: the CUDA kernel, its wrapper and its plain twin.

Port of the Pallas TPU kernel ``repro/kernels/rmsnorm.py`` (``rmsnorm``,
body ``_rmsnorm_kernel``): ``x * rsqrt(mean(x^2) + eps) * scale`` over the
last dimension in f32, output at x's type.  On Hopper one warp reduces one
row (``csrc/rmsnorm.cu``).  A CPU tensor goes to :func:`rmsnorm_plain`, a
CUDA tensor to the kernel, which launches or raises.  ``block_rows`` is
validated as the reference tiles rows, but with a ``ValueError`` where the
reference has a bare ``assert``; the CUDA kernel's own tile is one row.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_rows(shape, block_rows: int) -> tuple[int, int]:
    d = shape[-1]
    rows = 1
    for s in shape[:-1]:
        rows *= s
    br = min(block_rows, rows)
    if br <= 0 or rows % br:
        raise ValueError(
            f"rows={rows} is not divisible by block_rows={br}; legal "
            f"block_rows values divide the row count")
    return rows, d


def rmsnorm_plain(x, scale, *, eps: float = 1e-6):
    """The kernel's arithmetic in plain torch: f32 throughout, cast to x's
    type at the end.  The CPU path and the kernel's oracle."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_cuda(x, scale, *, eps: float = 1e-6):
    """Launch the CUDA kernel on a contiguous CUDA tensor x (..., d) with
    scale (d,).  Raises on what the kernel does not take and on a failed
    launch; never falls back."""
    from repro_torch.kernels import _build

    if not (x.is_cuda and scale.device == x.device):
        raise ValueError(f"rmsnorm_cuda needs x and scale on one CUDA "
                         f"device, got {x.device}, {scale.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"rmsnorm_cuda takes float32 or bfloat16, got "
                         f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm_cuda needs a contiguous x")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({d},)")
    rows = x.numel() // d
    scale32 = scale.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    lib = _build.load("rmsnorm")
    fn = lib.rmsnorm_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), scale32.data_ptr(), out.data_ptr(), rows, d,
                 float(eps), _DTYPE_CODE[x.dtype], stream)
    if err:
        raise RuntimeError(f"rmsnorm kernel launch failed: cudaError {err}")
    rmsnorm_cuda.launches += 1
    return out


rmsnorm_cuda.launches = 0


def rmsnorm(x, scale, *, eps: float = 1e-6, block_rows: int = 128):
    """x: (..., d); scale: (d,). Returns x's shape and dtype."""
    _check_rows(x.shape, block_rows)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps=eps)
    if x.device.type == "cuda":
        return rmsnorm_cuda(x, scale, eps=eps)
    raise ValueError(f"rmsnorm runs on cpu or cuda, not {x.device}")
