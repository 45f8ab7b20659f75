"""Fused RMSNorm: the CUDA kernels, their wrapper and the plain twin.

Port of the Pallas TPU kernel ``repro/kernels/rmsnorm.py`` (``rmsnorm``,
body ``_rmsnorm_kernel``): ``x * rsqrt(mean(x^2) + eps) * scale`` over the
last dimension in f32, output at x's type.  The work is memory-bound, so
on Hopper the row stays in registers and x is read once, by 16-byte loads
(``csrc/rmsnorm.cu``, which also says what bounds it).

Two routes, chosen before launch from x's shape, dtype and alignment
(:func:`rmsnorm_plan` states the route and tile; a launch that fails
raises, it never falls back to the other route):

  * ``vec``: 16-byte vectors, a group of threads per row, a persistent
    grid.  Takes ``d * elt`` a multiple of 16 bytes, ``d`` up to
    ``VEC_MAX_THREADS_PER_ROW * VEC_PER_THREAD`` vectors (8192 bf16,
    4096 f32) and a 16-byte-aligned x.
  * ``general``: one warp per row, one element a lane per load; anything
    else.

``rmsnorm_cuda`` counts its launches per route, in ``launches_vec`` and
``launches_general``; its ``launches`` is their sum.

A CPU tensor goes to :func:`rmsnorm_plain`, a CUDA tensor to the kernel,
which launches or raises.  ``block_rows`` is validated as the reference
tiles rows, but with a ``ValueError`` where the reference has a bare
``assert``; the CUDA tile is the kernel's own choice.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from repro_torch.kernels.routes import RouteCounted

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE_CODE = {"vec": 0, "general": 1}
_INT_MAX = 2 ** 31 - 1

# The vec route's tiling (csrc/rmsnorm.cu, namespace vec).
VEC_BYTES = 16
VEC_PER_THREAD = 4
VEC_CTA_THREADS = 256
VEC_CTAS_PER_SM = 2
VEC_MAX_THREADS_PER_ROW = 256
# The general route's CTA (csrc/rmsnorm.cu, rmsnorm_rows).
GENERAL_CTA_THREADS = 256
GENERAL_ROWS_PER_CTA = GENERAL_CTA_THREADS // 32


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


def vec_threads_per_row(d: int, elt: int) -> int:
    """Threads per row of the vec route: the least power of two from 32
    whose ``VEC_PER_THREAD`` vectors each cover the row; 0 where the route
    does not take (d, elt): rows not a whole number of 16-byte vectors or
    wider than ``VEC_MAX_THREADS_PER_ROW`` threads hold."""
    if d <= 0 or d * elt % VEC_BYTES:
        return 0
    vectors = d * elt // VEC_BYTES
    tpr = 32
    while tpr * VEC_PER_THREAD < vectors:
        tpr *= 2
    return tpr if tpr <= VEC_MAX_THREADS_PER_ROW else 0


def rmsnorm_plan(x) -> dict:
    """The route and tile the CUDA kernel takes for x (..., d): ``route``
    (``vec`` or ``general``), ``threads_per_row``, ``vectors_per_thread``
    (16-byte vectors; 0 for general's one-element loads), ``rows_per_cta``,
    ``ctas_per_sm`` (the vec route's persistent grid; 0 for general, whose
    grid covers the rows) and ``cta_threads``; a general plan also says
    why the vec route did not take x.  Raises ``ValueError`` for what no
    route takes."""
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"rmsnorm_cuda takes float32 or bfloat16, got "
                         f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm_cuda needs a contiguous x")
    if x.dim() == 0 or x.numel() == 0:
        raise ValueError(f"rmsnorm_cuda needs a non-empty x (..., d), got "
                         f"shape {tuple(x.shape)}")
    d = x.shape[-1]
    rows = x.numel() // d
    if rows > _INT_MAX or d > _INT_MAX:
        raise ValueError(f"rmsnorm_cuda: {rows} rows of {d} exceed the "
                         f"kernels' int range {_INT_MAX}")
    return dict(_plan(d, x.element_size(), x.data_ptr() % VEC_BYTES == 0))


@functools.cache
def _plan(d: int, elt: int, aligned: bool) -> dict:
    """The plan for rows of d elements of elt bytes, built once for each
    (d, elt, alignment): the route depends on nothing else."""
    tpr = vec_threads_per_row(d, elt)
    if tpr and aligned:
        return dict(route="vec", threads_per_row=tpr,
                    vectors_per_thread=VEC_PER_THREAD,
                    rows_per_cta=VEC_CTA_THREADS // tpr,
                    ctas_per_sm=VEC_CTAS_PER_SM, cta_threads=VEC_CTA_THREADS)
    if d * elt % VEC_BYTES:
        why = f"row of {d * elt} bytes is no multiple of {VEC_BYTES}"
    elif not tpr:
        why = (f"row of {d * elt // VEC_BYTES} vectors exceeds "
               f"{VEC_MAX_THREADS_PER_ROW * VEC_PER_THREAD}")
    else:
        why = f"base address is not {VEC_BYTES}-byte aligned"
    return dict(route="general", threads_per_row=32, vectors_per_thread=0,
                rows_per_cta=GENERAL_ROWS_PER_CTA, ctas_per_sm=0,
                cta_threads=GENERAL_CTA_THREADS, why=why)


# The C entry points' parameters: x, scale, y, rows, d, eps, dtype, stream
# (rmsnorm_tile: route, d, dtype, out) (csrc/rmsnorm.cu).
_LAUNCH_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
ARGTYPES = {
    "rmsnorm_vec_launch": _LAUNCH_ARGS,
    "rmsnorm_general_launch": _LAUNCH_ARGS,
    "rmsnorm_tile": [ctypes.c_int] * 3 + [ctypes.c_void_p],
}
_ENTRY = {"vec": "rmsnorm_vec_launch", "general": "rmsnorm_general_launch"}
TILE_KEYS = ("threads_per_row", "vectors_per_thread", "rows_per_cta",
             "ctas_per_sm", "cta_threads")


@functools.cache
def _library():
    """The built library, loaded once, with every entry point's ctypes
    signature set."""
    from repro_torch.kernels import _build

    lib = _build.load("rmsnorm")
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def built_tile(route: str, d: int, dtype) -> dict:
    """The built kernel's tile for a row of ``d`` at ``dtype`` on
    ``route`` (``rmsnorm_tile``): the :data:`TILE_KEYS` figures that
    :func:`rmsnorm_plan` must state, and ``resident_ctas_per_sm``, what the
    occupancy calculator finds for the built kernel (0 for general)."""
    out = (ctypes.c_int * 6)()
    if _library().rmsnorm_tile(_ROUTE_CODE[route], d, _DTYPE_CODE[dtype],
                               out):
        raise ValueError(f"the {route} route does not take d={d} at "
                         f"{dtype}")
    return dict(zip(TILE_KEYS + ("resident_ctas_per_sm",), out))


def _check_cuda(x, scale) -> None:
    if not (x.is_cuda and scale.get_device() == x.get_device()):
        raise ValueError(f"rmsnorm_cuda needs x and scale on one CUDA "
                         f"device, got {x.device}, {scale.device}")


def _device_stream(t):
    """A context that makes t's card current (none where it is already),
    and that card's current stream as an integer handle."""
    dev = t.get_device()
    return (contextlib.nullcontext() if dev == torch.cuda.current_device()
            else torch.cuda.device(dev),
            torch._C._cuda_getCurrentRawStream(dev))


@RouteCounted.over("vec", "general")
def rmsnorm_cuda(x, scale, *, eps: float = 1e-6):
    """Launch the route :func:`rmsnorm_plan` names on a CUDA tensor x
    (..., d) with scale (d,).  Raises on what the kernel does not take and
    on a failed launch; never falls back."""
    _check_cuda(x, scale)
    plan = rmsnorm_plan(x)
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({d},)")
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        scale = scale.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    fn = getattr(_library(), _ENTRY[plan["route"]])
    device, stream = _device_stream(x)
    with device:
        err = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                 x.numel() // d, d, float(eps), _DTYPE_CODE[x.dtype], stream)
    if err == -1:
        raise ValueError(f"rmsnorm: the {plan['route']} kernel refused "
                         f"{plan} for x {tuple(x.shape)} {x.dtype}")
    if err:
        raise RuntimeError(f"rmsnorm {plan['route']} launch failed: "
                           f"cudaError {err}")
    rmsnorm_cuda.count(plan)
    return out


def rmsnorm(x, scale, *, eps: float = 1e-6, block_rows: int = 128):
    """x: (..., d); scale: (d,). Returns x's shape and dtype."""
    _check_rows(x.shape, block_rows)
    if x.is_cpu:
        return rmsnorm_plain(x, scale, eps=eps)
    if x.is_cuda:
        return rmsnorm_cuda(x, scale, eps=eps)
    raise ValueError(f"rmsnorm runs on cpu or cuda, not {x.device}")
