"""Dispersed-accumulator GEMM: the cVRF trade-off at on-chip granularity.

Port of the Pallas TPU kernels ``repro/kernels/dispersed_gemm.py``:

  * :func:`matmul_grouped` (K3) — a compact set of W row-tile
    accumulators stays on chip while the whole K reduction completes for
    the group; the B panel is fetched once per (group, k) and reused W
    times, so B traffic scales as 1/W.
  * :func:`matmul_dispersed` (K4) — the W=0 extreme: the f32 accumulator
    round-trips through device memory on every k step.

On Hopper both run from one CUDA source (``csrc/dispersed_gemm.cu``,
which says how the TPU schedule maps onto CTAs and what bounds it), by
one of two routes chosen from the inputs' dtype alone:

  * bfloat16 and int8 take the tensor-core route (``gemm_tc``: TMA,
    ``wgmma``, K3's W row tiles as one cluster of W CTAs sharing each B
    chunk by TMA multicast).  It takes block_m in (64, 128, 256), k a
    multiple of 64 (and K4's block_k too), W <= 8, n a multiple of 8 for
    bfloat16 and of 4 for K4 (TMA's 16-byte rows); :func:`tc_plan`
    states the tiles and raises ``ValueError`` for anything else.
  * float32 takes the FMA route (``gemm_rows`` on the CUDA cores, no
    TF32), whose CTA holds W * block_m rows: a power of two in [8, 2048].

Each ``*_cuda`` function counts its launches per route, in
``launches_tc`` and ``launches_fma``; its ``launches`` is their sum.
There is no fallback from one route to the other.  Each kernel has a plain twin that computes
A@B block by block in k order in f32 and casts at the end; a CPU tensor
goes to the twin, a CUDA tensor to the kernel, which launches or raises.

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
from repro_torch.kernels.routes import RouteCounted

ACC_BYTES = 4      # both schedules accumulate in f32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# The tensor-core route's tiling (csrc/dispersed_gemm.cu, namespace tc).
TC_BLOCK_M = (64, 128, 256)
TC_K_CHUNK = 64            # k per shared-memory stage: 128 bytes of bf16
TC_MAX_CLUSTER = 8         # CTAs of a portable thread-block cluster
SMEM_LIMIT = 232448        # shared memory one block may use on sm_90
_TC_ALIGN, _TC_MAX_STAGES, _TC_BARRIERS = 1024, 5, 16
# The FMA route's CTA (csrc/dispersed_gemm.cu, gemm_rows).
_FMA_ACC_PER_CTA, _FMA_KC, _FMA_PAD = 16384, 16, 4


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


def tc_plan(m: int, n: int, k: int, *, block_m: int, block_k: int,
            working_set: int, dtype) -> dict:
    """The route and CTA tiling the card takes for ``A (m, k) @ B (k, n)``
    of ``dtype``: K3 for ``working_set >= 1``, K4 for ``working_set=0``.

    Returns ``route`` ("tc" for bfloat16 and int8, "fma" for float32),
    ``cluster`` (CTAs per cluster: W for K3 on the tensor cores, else 1),
    ``block_m`` and ``n_tile`` (the CTA's tile of C; on the tensor cores
    ``n_tile`` depends on block_m only, never on W), ``stages`` (shared-
    memory stages), ``smem_bytes`` and ``acc_per_thread`` (f32
    accumulators a thread holds); for K4 on the tensor cores also
    ``fill_stages`` and ``fill_smem_bytes``: the steps that start from
    the f32 C buffer keep the C tile in shared memory beside fewer
    stages.  Raises the reference's ``ValueError``s for the tiling and
    the route's own for what its kernel does not take; the C entry
    points check the same rules.
    """
    block_m, block_k, nm, _ = _check_tiles(m, k, k, block_m=block_m,
                                           block_k=block_k)
    w = _check_working_set(working_set, nm)[0] if working_set else 0
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"dispersed_gemm takes float32, bfloat16 or int8, "
                         f"not {dtype}")
    if dtype == torch.float32:
        rows = w * block_m if w else block_m
        if rows < 8 or rows > 2048 or rows & (rows - 1):
            raise ValueError(
                f"dispersed_gemm: the kernel's CTA holds {rows} rows "
                f"(working_set * block_m); it takes a power of two in "
                f"[8, 2048]")
        cols = _FMA_ACC_PER_CTA // rows
        return dict(route="fma", cluster=1, block_m=rows, n_tile=cols,
                    stages=1, acc_per_thread=64,
                    smem_bytes=4 * _FMA_KC * (rows + _FMA_PAD + cols))
    if block_m not in TC_BLOCK_M:
        raise ValueError(
            f"dispersed_gemm: the tensor-core route takes block_m in "
            f"{TC_BLOCK_M} (wgmma's 64-row tiles), got {block_m}")
    if w > TC_MAX_CLUSTER:
        raise ValueError(
            f"dispersed_gemm: the tensor-core route holds a group's W row "
            f"tiles in one cluster of at most {TC_MAX_CLUSTER} CTAs, got "
            f"working_set={w}")
    if k % TC_K_CHUNK or (not w and block_k % TC_K_CHUNK):
        raise ValueError(
            f"dispersed_gemm: the tensor-core route walks k in chunks of "
            f"{TC_K_CHUNK}; k={k}" + ("" if w else f" and block_k={block_k}")
            + f" must be multiples of {TC_K_CHUNK}")
    if dtype == torch.bfloat16 and n % 8:
        raise ValueError(
            f"dispersed_gemm: the bfloat16 route reads B by TMA, whose rows "
            f"must be a multiple of 16 bytes; n={n} is not a multiple of 8")
    if not w and n % 4:
        raise ValueError(
            f"dispersed_gemm: K4 on the tensor cores reads its f32 C buffer "
            f"by TMA, whose rows must be a multiple of 16 bytes; n={n} is "
            f"not a multiple of 4")
    n_tile = 128 if block_m == 256 else 256
    wg_m, wg_n = (64, n_tile // 2) if block_m == 64 else (block_m // 2,
                                                          n_tile)
    stage = (block_m + n_tile) * TC_K_CHUNK * 2

    def ring(c_bytes):
        extra = c_bytes + (_TC_BARRIERS if c_bytes else 0)
        stages = min(_TC_MAX_STAGES, (SMEM_LIMIT - _TC_ALIGN - extra)
                     // (stage + _TC_BARRIERS))
        return stages, _TC_ALIGN + stages * (stage + _TC_BARRIERS) + extra

    stages, smem = ring(0)
    plan = dict(route="tc", cluster=max(w, 1), block_m=block_m,
                n_tile=n_tile, stages=stages,
                acc_per_thread=wg_m * wg_n // 128, smem_bytes=smem)
    if not w:
        # K4's steps after the first also hold the f32 C tile in shared
        # memory, loaded by TMA
        plan["fill_stages"], plan["fill_smem_bytes"] = ring(
            block_m * n_tile * ACC_BYTES)
    return plan


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


# The C entry points' parameters: a, b, acc, out, then ints, then the
# stream (csrc/dispersed_gemm.cu).
ARGTYPES = {
    "gemm_rows_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p],
    "gemm_tc_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p],
    "gemm_tc_tile": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def _stream(a):
    return torch.cuda.current_stream(a.device).cuda_stream


def _launch(a, b, acc, out, *, k_begin, k_end, rows, load_acc, store_out):
    """The FMA route (f32): one ``gemm_rows`` launch."""
    from repro_torch.kernels import _build

    fn = _build.load("dispersed_gemm").gemm_rows_launch
    fn.argtypes, fn.restype = ARGTYPES["gemm_rows_launch"], ctypes.c_int
    m, k = a.shape
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(),
                 acc.data_ptr() if acc is not None else None,
                 out.data_ptr() if out is not None else None,
                 m, b.shape[1], k, k_begin, k_end, rows, int(load_acc),
                 int(store_out), _DTYPE_CODE[a.dtype], _stream(a))
    if err == -1:
        raise ValueError(
            f"dispersed_gemm: the kernel's CTA holds {rows} rows "
            f"(working_set * block_m); it takes a power of two in "
            f"[8, 2048]")
    if err:
        raise RuntimeError(f"dispersed_gemm kernel launch failed: "
                           f"cudaError {err}")


def _launch_tc(a, b, acc, out, *, k_begin, k_end, plan, load_acc,
               store_out):
    """The tensor-core route (bf16, int8): one ``gemm_tc`` launch."""
    from repro_torch.kernels import _build

    fn = _build.load("dispersed_gemm").gemm_tc_launch
    fn.argtypes, fn.restype = ARGTYPES["gemm_tc_launch"], ctypes.c_int
    m, k = a.shape
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(),
                 acc.data_ptr() if acc is not None else None,
                 out.data_ptr() if out is not None else None,
                 m, b.shape[1], k, k_begin, k_end, plan["block_m"],
                 plan["cluster"], int(load_acc), int(store_out),
                 _DTYPE_CODE[a.dtype], _stream(a))
    if err == -1:
        raise ValueError(
            f"dispersed_gemm: the tensor-core kernel refused {plan} for "
            f"{tuple(a.shape)} @ {tuple(b.shape)} (a and b must start on "
            f"16-byte boundaries)")
    if err == -2:
        raise ValueError(
            f"dispersed_gemm: this card holds no cluster of "
            f"{plan['cluster']} CTAs of {plan['smem_bytes']} bytes of "
            f"shared memory (working_set={plan['cluster']})")
    if err:
        raise RuntimeError(f"dispersed_gemm tensor-core launch failed "
                           f"(cluster of {plan['cluster']}): cudaError {err}")


def built_tc_tile(block_m: int, fill: bool) -> dict:
    """The built kernel's CTA tile at ``block_m`` (``gemm_tc_tile``; fill:
    K4's launches that start from the f32 C buffer): ``n_tile``,
    ``stages`` and ``smem_bytes``, the figures :func:`tc_plan` must state.
    Loads (and if need be builds) the library."""
    from repro_torch.kernels import _build

    fn = _build.load("dispersed_gemm").gemm_tc_tile
    fn.argtypes, fn.restype = ARGTYPES["gemm_tc_tile"], ctypes.c_int
    out = (ctypes.c_int * 3)()
    if fn(block_m, int(fill), out):
        raise ValueError(f"dispersed_gemm: the tensor-core route takes "
                         f"block_m in {TC_BLOCK_M}, got {block_m}")
    return dict(n_tile=out[0], stages=out[1], smem_bytes=out[2])


@RouteCounted
def matmul_grouped_cuda(a, b, *, block_m: int = 128, block_k: int = 512,
                        working_set: int = 4):
    """K3 on the card: one launch.  bf16/int8: tensor cores, a cluster of
    W CTAs per group; f32: CUDA cores, one CTA per (group, N slice)."""
    m, k, k2, n = _shapes(a, b)
    block_m, block_k, nm, _ = _check_tiles(m, k, k2, block_m=block_m,
                                           block_k=block_k)
    w, _ = _check_working_set(working_set, nm)
    _check_cuda(a, b, "matmul_grouped_cuda")
    plan = tc_plan(m, n, k, block_m=block_m, block_k=block_k,
                   working_set=w, dtype=a.dtype)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if plan["route"] == "tc":
        _launch_tc(a, b, None, out, k_begin=0, k_end=k, plan=plan,
                   load_acc=False, store_out=True)
    else:
        _launch(a, b, None, out, k_begin=0, k_end=k, rows=plan["block_m"],
                load_acc=False, store_out=True)
    matmul_grouped_cuda.count(plan)
    return out


@RouteCounted
def matmul_dispersed_cuda(a, b, *, block_m: int = 128, block_k: int = 512):
    """K4 on the card: one launch per k step (nk per call), the f32
    accumulator read from and written back to device memory each step."""
    m, k, k2, n = _shapes(a, b)
    block_m, block_k, _, nk = _check_tiles(m, k, k2, block_m=block_m,
                                           block_k=block_k)
    _check_cuda(a, b, "matmul_dispersed_cuda")
    plan = tc_plan(m, n, k, block_m=block_m, block_k=block_k,
                   working_set=0, dtype=a.dtype)
    acc = torch.empty((m, n), dtype=torch.float32, device=a.device)
    out = acc if a.dtype == torch.float32 else torch.empty(
        (m, n), dtype=a.dtype, device=a.device)
    for ik in range(nk):
        last = ik == nk - 1
        kw = dict(k_begin=ik * block_k, k_end=(ik + 1) * block_k,
                  load_acc=ik > 0, store_out=last)
        if plan["route"] == "tc":
            _launch_tc(a, b, acc, out if last else None, plan=plan, **kw)
        else:
            _launch(a, b, acc, out if last else None, rows=block_m, **kw)
        matmul_dispersed_cuda.count(plan)
    return out


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
