"""Dispersed-accumulator GEMM: the cVRF trade-off at on-chip granularity.

Port of the Pallas TPU kernels ``repro/kernels/dispersed_gemm.py``:

  * :func:`matmul_grouped` (K3) — a compact set of W row-tile
    accumulators stays on chip while the whole K reduction completes for
    the group; the B panel is fetched once per (group, k) and reused W
    times, so B traffic scales as 1/W.
  * :func:`matmul_dispersed` (K4) — the W=0 extreme: the f32 accumulator
    round-trips through device memory on every k step.

On Hopper both run one CUDA kernel (``csrc/dispersed_gemm.cu``, which
says how the TPU schedule maps onto CTAs and what bounds it).  Each has a
plain twin that computes A@B block by block in k order in f32 and casts
at the end; a CPU tensor goes to the twin, a CUDA tensor to the kernel,
which launches or raises.

``hbm_traffic_model`` gives the closed-form bytes for the roofline;
``grouped_schedule`` / ``dispersed_schedule`` expose the reference's grids
and index maps, so :func:`repro_torch.kernels.traffic.count` can hold the
closed form against the schedule.  Both are the *schedule's* bytes, not
bytes measured on the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import traffic
from repro_torch.kernels.ref import cast_like

ACC_BYTES = 4      # both schedules accumulate in f32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _check_tiles(m: int, k: int, k2: int, *, block_m: int, block_k: int):
    """Shared kernel/model legality: clamp blocks, then require exact
    tiling.  Raises ``ValueError`` naming the offending dimension."""
    if k != k2:
        raise ValueError(
            f"contraction mismatch: a has k={k} columns but b has k={k2} "
            f"rows")
    block_m = min(block_m, m)
    block_k = min(block_k, k)
    if block_m <= 0 or block_k <= 0:
        raise ValueError(
            f"block_m/block_k must be positive, got ({block_m}, {block_k})")
    if m % block_m:
        raise ValueError(
            f"m={m} is not divisible by block_m={block_m}; legal block_m "
            f"values divide m (e.g. {[d for d in (8, 16, 32, 64, 128, 256) if m % d == 0]})")
    if k % block_k:
        raise ValueError(
            f"k={k} is not divisible by block_k={block_k}; legal block_k "
            f"values divide k (e.g. {[d for d in (64, 128, 256, 512) if k % d == 0]})")
    return block_m, block_k, m // block_m, k // block_k


def _check_working_set(working_set: int, nm: int) -> tuple[int, int]:
    """Clamp W to the tile count, then require it to divide ``nm`` —
    the grouped grid is (groups, k, W) with groups = nm / W."""
    if working_set < 1:
        raise ValueError(
            f"working_set must be >= 1, got {working_set} (use "
            f"matmul_dispersed for the W=0 extreme)")
    w = min(working_set, nm)
    if nm % w:
        raise ValueError(
            f"working_set={working_set} (clamped to {w}) does not divide "
            f"the m-tile count nm={nm}; legal working sets: "
            f"{[d for d in range(1, nm + 1) if nm % d == 0]}")
    return w, nm // w


def _grouped_maps(w: int):
    """The grouped schedule's index maps (grid (groups, k, W))."""
    a = lambda g, ik, iw: (g * w + iw, ik)
    b = lambda g, ik, iw: (ik, 0)
    o = lambda g, ik, iw: (g * w + iw, 0)
    return a, b, o


def _dispersed_maps():
    """The dispersed schedule's index maps (grid (k, m))."""
    a = lambda ik, im: (im, ik)
    b = lambda ik, im: (ik, 0)
    o = lambda ik, im: (im, 0)
    return a, b, o


def _shapes(a, b):
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul takes 2-d a and b, got shapes "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    return a.shape[0], a.shape[1], b.shape[0], b.shape[1]


# ---------------------------------------------------------------------------
# Plain twins: the CPU path and the kernels' oracle.
# ---------------------------------------------------------------------------


def _blocked_plain(a, b, block_k: int):
    """A@B block by block in k order, accumulated in f32, cast at the end
    with JAX's semantics (saturating for int8)."""
    m, k = a.shape
    acc = torch.zeros((m, b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, k, block_k):
        acc += a[:, k0:k0 + block_k].float() @ b[k0:k0 + block_k].float()
    return cast_like(acc, a.dtype)


def matmul_grouped_plain(a, b, *, block_m: int = 128, block_k: int = 512,
                         working_set: int = 4):
    """K3's plain twin (validates like the kernel; W does not change the
    result)."""
    m, k, k2, _ = _shapes(a, b)
    block_m, block_k, nm, _ = _check_tiles(m, k, k2, block_m=block_m,
                                           block_k=block_k)
    _check_working_set(working_set, nm)
    return _blocked_plain(a, b, block_k)


def matmul_dispersed_plain(a, b, *, block_m: int = 128, block_k: int = 512):
    """K4's plain twin."""
    m, k, k2, _ = _shapes(a, b)
    _, block_k, _, _ = _check_tiles(m, k, k2, block_m=block_m,
                                    block_k=block_k)
    return _blocked_plain(a, b, block_k)


matmul_grouped_plain.calls = 0
matmul_dispersed_plain.calls = 0


# ---------------------------------------------------------------------------
# The CUDA kernels.
# ---------------------------------------------------------------------------


def _check_cuda(a, b, name: str):
    if not (a.is_cuda and b.device == a.device):
        raise ValueError(f"{name} needs a and b on one CUDA device, got "
                         f"{a.device}, {b.device}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError(f"{name} takes float32, bfloat16 or int8, both "
                         f"alike; got {a.dtype}, {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name} needs row-major contiguous a and b")


def _launch(a, b, acc, out, *, k_begin, k_end, rows, load_acc, store_out):
    from repro_torch.kernels import _build

    lib = _build.load("dispersed_gemm")
    fn = lib.gemm_rows_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    m, k = a.shape
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(),
                 acc.data_ptr() if acc is not None else None,
                 out.data_ptr() if out is not None else None,
                 m, b.shape[1], k, k_begin, k_end, rows, int(load_acc),
                 int(store_out), _DTYPE_CODE[a.dtype], stream)
    if err == -1:
        raise ValueError(
            f"dispersed_gemm: the kernel's CTA holds {rows} rows "
            f"(working_set * block_m); it takes a power of two in "
            f"[8, 2048]")
    if err:
        raise RuntimeError(f"dispersed_gemm kernel launch failed: "
                           f"cudaError {err}")


def matmul_grouped_cuda(a, b, *, block_m: int = 128, block_k: int = 512,
                        working_set: int = 4):
    """K3 on the card: one launch, one CTA per (group, N slice)."""
    m, k, k2, n = _shapes(a, b)
    block_m, block_k, nm, _ = _check_tiles(m, k, k2, block_m=block_m,
                                           block_k=block_k)
    w, _ = _check_working_set(working_set, nm)
    _check_cuda(a, b, "matmul_grouped_cuda")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    _launch(a, b, None, out, k_begin=0, k_end=k, rows=w * block_m,
            load_acc=False, store_out=True)
    matmul_grouped_cuda.launches += 1
    return out


def matmul_dispersed_cuda(a, b, *, block_m: int = 128, block_k: int = 512):
    """K4 on the card: one launch per k step (nk per call), the f32
    accumulator read from and written back to device memory each step."""
    m, k, k2, n = _shapes(a, b)
    block_m, block_k, _, nk = _check_tiles(m, k, k2, block_m=block_m,
                                           block_k=block_k)
    _check_cuda(a, b, "matmul_dispersed_cuda")
    acc = torch.empty((m, n), dtype=torch.float32, device=a.device)
    out = acc if a.dtype == torch.float32 else torch.empty(
        (m, n), dtype=a.dtype, device=a.device)
    for ik in range(nk):
        last = ik == nk - 1
        _launch(a, b, acc, out if last else None, k_begin=ik * block_k,
                k_end=(ik + 1) * block_k, rows=block_m, load_acc=ik > 0,
                store_out=last)
        matmul_dispersed_cuda.launches += 1
    return out


matmul_grouped_cuda.launches = 0
matmul_dispersed_cuda.launches = 0


def _dispatch(plain, cuda, a, b, **kw):
    if a.device.type == "cpu":
        plain.calls += 1
        return plain(a, b, **kw)
    if a.device.type == "cuda":
        return cuda(a, b, **kw)
    raise ValueError(f"matmul runs on cpu or cuda, not {a.device}")


def matmul_grouped(a, b, *, block_m: int = 128, block_k: int = 512,
                   working_set: int = 4):
    """C = A @ B with a compact, on-chip accumulator working set (K3)."""
    return _dispatch(matmul_grouped_plain, matmul_grouped_cuda, a, b,
                     block_m=block_m, block_k=block_k,
                     working_set=working_set)


def matmul_dispersed(a, b, *, block_m: int = 128, block_k: int = 512):
    """The no-cache extreme: every accumulator revisit spills/fills device
    memory (K4)."""
    return _dispatch(matmul_dispersed_plain, matmul_dispersed_cuda, a, b,
                     block_m=block_m, block_k=block_k)


# ---------------------------------------------------------------------------
# Traffic geometry: the measured side of the roofline's model check.
# ---------------------------------------------------------------------------


def grouped_schedule(m: int, n: int, k: int, *, block_m: int, block_k: int,
                     working_set: int,
                     bytes_per_el: int = 2) -> traffic.Schedule:
    """The grouped schedule's grid + operand parts (A/B stream in at the
    input width; C is a pure output — the accumulator stays on chip)."""
    block_m, block_k, nm, nk = _check_tiles(
        m, k, k, block_m=block_m, block_k=block_k)
    w, groups = _check_working_set(working_set, nm)
    a_map, b_map, o_map = _grouped_maps(w)
    return traffic.Schedule(
        grid=(groups, nk, w),
        parts=(
            traffic.Part("a", block_m * block_k * bytes_per_el, a_map, "in"),
            traffic.Part("b", block_k * n * bytes_per_el, b_map, "in"),
            traffic.Part("c", block_m * n * bytes_per_el, o_map, "out"),
        ))


def dispersed_schedule(m: int, n: int, k: int, *, block_m: int,
                       block_k: int,
                       bytes_per_el: int = 2) -> traffic.Schedule:
    """The dispersed schedule's geometry: C is a memory-resident
    accumulator (kind ``"acc"``) — every revisit is a fill + spill at f32
    width."""
    block_m, block_k, nm, nk = _check_tiles(
        m, k, k, block_m=block_m, block_k=block_k)
    a_map, b_map, o_map = _dispersed_maps()
    return traffic.Schedule(
        grid=(nk, nm),
        parts=(
            traffic.Part("a", block_m * block_k * bytes_per_el, a_map, "in"),
            traffic.Part("b", block_k * n * bytes_per_el, b_map, "in"),
            traffic.Part("c", block_m * n * ACC_BYTES, o_map, "acc"),
        ))


def hbm_traffic_model(m: int, n: int, k: int, *, block_m: int, block_k: int,
                      working_set: int, bytes_per_el: int = 2) -> dict:
    """Closed-form device-memory bytes for the two schedules.

    grouped: A once, B once per group (= nm/W fetches of the full panel),
    C written once — all at the input element width.
    dispersed: A once, B once (reused across m at fixed k), C spilled AND
    filled on each of the nk k-steps at the f32 accumulator width.

    Legality mirrors the kernels: the model raises exactly where
    ``matmul_grouped`` does.
    """
    block_m, block_k, nm, nk = _check_tiles(
        m, k, k, block_m=block_m, block_k=block_k)
    w, groups = _check_working_set(working_set, nm)
    grouped = (m * k + groups * k * n + m * n) * bytes_per_el
    dispersed = (m * k + k * n) * bytes_per_el + 2 * m * n * nk * ACC_BYTES
    ideal = (m * k + k * n + m * n) * bytes_per_el
    return dict(grouped=grouped, dispersed=dispersed, ideal=ideal,
                vmem_acc_bytes=w * block_m * n * ACC_BYTES)
