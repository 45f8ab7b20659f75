"""FlashAttention-2 forward: the CUDA kernels, their wrapper and the plain twin.

Port of the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, body ``_flash_kernel``).  On the TPU the running max,
normaliser and output accumulator live in VMEM scratch and K/V stream
through it block by block; on Hopper a CTA keeps them in registers and
loops over K/V tiles in shared memory (``csrc/flash_attention.cu``, which
also says what bounds it).

Two routes, chosen by the inputs' dtype alone (:func:`flash_plan` states
the route and tile, and raises ``ValueError`` for what the route does not
take; there is no fallback from one to the other):

  * bfloat16 takes the tensor-core route (``flash_tc``: TMA, ``wgmma``,
    a persistent CTA of 128 query rows per work item, P rounded to bf16
    for the P V product).  It takes base addresses and batch/head/sequence
    strides that are multiples of 16 bytes.
  * float32 and int8 take the CUDA-core route (``flash_fwd``, FP32 FMAs).

``flash_attention_cuda`` counts its launches per route, in
``launches_tc`` and ``launches_fma``; its ``launches`` is their sum.

Dispatch is by the device of the tensors: a CPU tensor goes to
:func:`flash_attention_plain`, a CUDA tensor to the kernel, which launches
or raises.  ``block_q``/``block_k`` are validated as the reference does
(same ``ValueError``s) and otherwise unused: the CUDA tile is the kernel's
own choice.

``flash_schedule`` and ``hbm_traffic_model`` give the reference's grid,
index maps and closed-form bytes for the roofline: the schedule's count,
not bytes measured on the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import traffic
from repro_torch.kernels.ref import cast_like
from repro_torch.kernels.routes import RouteCounted

NEG_INF = -1e30
LANES = 128
ACC_BYTES = 4      # m/l/acc scratch is f32
HEAD_DIMS = (32, 64, 96, 128)       # instantiated in the CUDA source
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# The tensor-core route's tiling (csrc/flash_attention.cu, namespace tc).
TC_BQ, TC_BK, TC_STAGES = 128, 128, 2
SMEM_LIMIT = 232448        # shared memory one block may use on sm_90
_TC_ALIGN = 1024
_TC_BARRIERS = 8 * (2 + 4 * TC_STAGES)
# The CUDA-core route's CTA (csrc/flash_attention.cu, flash_fwd).
FMA_BQ = FMA_BK = 64
_GRID_Y = 65535            # flash_fwd's grid is (query tiles, b * h)
_INT_MAX = 2 ** 31 - 1


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


def _flash_maps():
    """The reference's index maps over the grid (b*h, q blocks, kv
    blocks), shared with :func:`flash_schedule`."""
    q = lambda bh_, iq, ik: (bh_, iq, 0)
    kv = lambda bh_, iq, ik: (bh_, ik, 0)
    o = lambda bh_, iq, ik: (bh_, iq, 0)
    return q, kv, o


def flash_attention_plain(q, k, v, *, causal: bool = False,
                          scale: float | None = None):
    """Plain-torch attention with the kernel's semantics: f32 scores, the
    top-left causal rule (row i sees columns j <= i) with the finite
    NEG_INF, output cast to q's dtype (int8 truncated and saturated, as
    JAX casts).  k/v may have fewer heads than q
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
    return cast_like(out, q.dtype)


flash_attention_plain.calls = 0


def _tma_strides(t) -> list[int]:
    """t's batch, head and sequence strides in elements, as the tensor
    maps take them.  A dimension of size 1 is never stepped, so its stride
    (which torch leaves free) is replaced by the tensor's span."""
    (sb, sh, ss, _), (b, h, s, d) = t.stride(), t.shape
    span = max(sb * b, sh * h, ss * s, d)
    return [sb if b > 1 else span, sh if h > 1 else span,
            ss if s > 1 else span]


def flash_plan(q, k, v) -> dict:
    """The route and CTA tiling the card takes for attention of q
    (B, Hq, Sq, D) against k/v (B, Hkv, Sk, D).

    Returns ``route`` ("tc" for bfloat16, "fma" for float32 and int8),
    ``block_q`` and ``block_k`` (the CTA's query rows and KV tile),
    ``stages`` (the K/V ring's depth) and ``smem_bytes`` (dynamic shared
    memory); on the tensor cores also ``swizzle`` (bytes: 128 where D is
    a multiple of 64, else 64), ``boxes`` (TMA boxes per tile row),
    ``items`` (the persistent grid's work items) and ``tma_strides``
    (q's, k's and v's batch, head and sequence strides as the kernel
    takes them, see :func:`_tma_strides`).  Raises ``ValueError``
    for what the route does not take; the C entry points check the same
    rules.
    """
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention_cuda takes float32, bfloat16 or "
                         f"int8, all alike; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
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
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a unit stride along the head dim")
    if min(b, hq, sq, sk) <= 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if q.dtype != torch.bfloat16:
        if b * hq > _GRID_Y:
            raise ValueError(f"batch*heads={b * hq} exceeds the grid limit "
                             f"{_GRID_Y}")
        smem = 4 * (FMA_BQ * (d + 1) + FMA_BK * (d + 1) + FMA_BK * d
                    + FMA_BQ * (FMA_BK + 1))
        return dict(route="fma", block_q=FMA_BQ, block_k=FMA_BK, stages=1,
                    smem_bytes=smem)
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention: the bfloat16 route reads {name} by TMA, "
                f"whose base address must be a multiple of 16 bytes")
        sb, sh, ss = _tma_strides(t)
        strides += (sb, sh, ss)
        if min(sb, sh, ss) <= 0 or (sb | sh | ss) % 8:
            raise ValueError(
                f"flash_attention: the bfloat16 route reads {name} by TMA, "
                f"whose batch, head and sequence strides must be positive "
                f"multiples of 16 bytes; got strides {tuple(t.stride())} "
                f"elements")
    items = b * hq * -(-sq // TC_BQ)
    if items > _INT_MAX:
        raise ValueError(f"flash_attention: {items} work items (b * h * "
                         f"query tiles) exceed the grid limit {_INT_MAX}")
    swizzle = 128 if d % 64 == 0 else 64
    smem = (_TC_ALIGN + TC_BQ * d * 2 + 2 * TC_STAGES * TC_BK * d * 2
            + _TC_BARRIERS)
    return dict(route="tc", block_q=TC_BQ, block_k=TC_BK, stages=TC_STAGES,
                smem_bytes=smem, swizzle=swizzle, boxes=d // (swizzle // 2),
                items=items, tma_strides=strides)


# The C entry points' parameters: q, k, v, o, six ints, twelve strides,
# scale, causal, (flash_attention_fwd: dtype), stream
# (csrc/flash_attention.cu).
_LAUNCH_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                + [ctypes.c_int64] * 12 + [ctypes.c_float, ctypes.c_int])
ARGTYPES = {
    "flash_attention_fwd": _LAUNCH_ARGS + [ctypes.c_int, ctypes.c_void_p],
    "flash_tc_launch": _LAUNCH_ARGS + [ctypes.c_void_p],
    "flash_tc_tile": [ctypes.c_int, ctypes.c_void_p],
}


def built_tc_tile(d: int) -> dict:
    """The built kernel's CTA tile at head dim ``d`` (``flash_tc_tile``):
    ``block_q``, ``block_k``, ``stages`` and ``smem_bytes``, the figures
    :func:`flash_plan` must state.  Loads (and if need be builds) the
    library."""
    from repro_torch.kernels import _build

    fn = _build.load("flash_attention").flash_tc_tile
    fn.argtypes, fn.restype = ARGTYPES["flash_tc_tile"], ctypes.c_int
    out = (ctypes.c_int * 4)()
    if fn(d, out):
        raise ValueError(f"head dim {d} not supported; have {HEAD_DIMS}")
    return dict(block_q=out[0], block_k=out[1], stages=out[2],
                smem_bytes=out[3])


def _check_cuda(q, k, v) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")


def _device_stream(t):
    """A context that makes t's card current, and that card's current
    stream as an integer handle."""
    return (torch.cuda.device(t.device),
            torch.cuda.current_stream(t.device).cuda_stream)


@RouteCounted
def flash_attention_cuda(q, k, v, *, causal: bool, scale: float):
    """Launch the route :func:`flash_plan` names on CUDA tensors q
    (B, Hq, Sq, D) and k/v (B, Hkv, Sk, D), Hq a multiple of Hkv, each
    with a unit stride along D.  The output has q's strides.  Raises on
    anything the route does not take and on a failed launch; never falls
    back."""
    from repro_torch.kernels import _build

    _check_cuda(q, k, v)
    plan = flash_plan(q, k, v)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    if plan["route"] == "tc":
        fn, extra = lib.flash_tc_launch, []
        fn.argtypes = ARGTYPES["flash_tc_launch"]
        strides = plan["tma_strides"] + _tma_strides(out)
    else:
        fn, extra = lib.flash_attention_fwd, [_DTYPE_CODE[q.dtype]]
        fn.argtypes = ARGTYPES["flash_attention_fwd"]
        strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    fn.restype = ctypes.c_int
    device, stream = _device_stream(q)
    with device:
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, hq, hkv, sq, sk, d, *strides, float(scale), int(causal),
                 *extra, stream)
    if err == -1:
        raise ValueError(f"flash_attention: the {plan['route']} kernel "
                         f"refused {plan} for q {tuple(q.shape)} strides "
                         f"{tuple(q.stride())}, k {tuple(k.shape)}")
    if err:
        raise RuntimeError(f"flash_attention {plan['route']} launch failed: "
                           f"cudaError {err}")
    flash_attention_cuda.count(plan)
    return out


def _attend(q, k, v, *, causal: bool, scale: float | None):
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if q.device.type == "cpu":
        flash_attention_plain.calls += 1
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


# ---------------------------------------------------------------------------
# Traffic geometry: the measured side of the roofline's model check.
# ---------------------------------------------------------------------------


def flash_schedule(b: int, h: int, sq: int, sk: int, d: int, *,
                   block_q: int, block_k: int,
                   bytes_per_el: int = 2) -> traffic.Schedule:
    """The reference schedule's grid + operand parts.  Q and O move once;
    K/V are re-streamed once per q block (the price of the O(1) working
    set)."""
    block_q, block_k, nq, nk = _check_blocks(
        sq, sk, block_q=block_q, block_k=block_k)
    q_map, kv_map, o_map = _flash_maps()
    return traffic.Schedule(
        grid=(b * h, nq, nk),
        parts=(
            traffic.Part("q", block_q * d * bytes_per_el, q_map, "in"),
            traffic.Part("k", block_k * d * bytes_per_el, kv_map, "in"),
            traffic.Part("v", block_k * d * bytes_per_el, kv_map, "in"),
            traffic.Part("o", block_q * d * bytes_per_el, o_map, "out"),
        ))


def hbm_traffic_model(b: int, h: int, sq: int, sk: int, d: int, *,
                      block_q: int, block_k: int,
                      bytes_per_el: int = 2) -> dict:
    """Closed-form device-memory bytes for attention schedules.

    flash: Q and O once; the K/V panels re-streamed once per q block.
    materialized: the dispersed extreme — the (sq, sk) score matrix is
    spilled and refilled at f32 width, as a non-fused attention would.
    ideal: every operand exactly once.
    """
    block_q, block_k, nq, nk = _check_blocks(
        sq, sk, block_q=block_q, block_k=block_k)
    bh = b * h
    q_bytes = bh * sq * d * bytes_per_el
    kv_bytes = bh * sk * d * bytes_per_el           # one of K or V
    o_bytes = q_bytes
    flash = q_bytes + o_bytes + 2 * nq * kv_bytes
    scores = bh * sq * sk * ACC_BYTES
    materialized = q_bytes + o_bytes + 2 * kv_bytes + 2 * scores
    ideal = q_bytes + o_bytes + 2 * kv_bytes
    return dict(flash=flash, materialized=materialized, ideal=ideal,
                vmem_acc_bytes=(block_q * d + 2 * block_q * LANES)
                * ACC_BYTES)
