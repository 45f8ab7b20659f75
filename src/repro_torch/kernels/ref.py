"""Plain-torch oracles for the kernels (the ``ref.py`` layer).

Port of ``repro/kernels/ref.py``.  :func:`cast_like` is the one place the
port converts an f32 result to the kernels' output type: JAX converts
f32 to an integer type *saturating*, truncating toward zero, while
``Tensor.to(torch.int8)`` wraps, so every int8 output goes through it.
"""

from __future__ import annotations

import torch


def cast_like(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.astype(dtype)`` with JAX's semantics: floats round to nearest
    even; integer types truncate toward zero and saturate at the type's
    range (``[-300.7, 200.2, 1000.] -> [-128, 127, 127]`` for int8)."""
    if dtype.is_floating_point:
        return x.to(dtype)
    info = torch.iinfo(dtype)
    return torch.clamp(torch.trunc(x.float()), info.min, info.max).to(dtype)


def attention_ref(q, k, v, *, causal: bool = False,
                  scale: float | None = None) -> torch.Tensor:
    """Reference attention. q,k,v: (B, H, S, D) with equal head counts.

    The causal mask is aligned bottom-right (``tril(k=sk-sq)``), as in the
    reference's oracle; the kernels align it top-left, which differs when
    sq < sk."""
    sq, d = q.shape[-2], q.shape[-1]
    sk = k.shape[-2]
    if scale is None:
        scale = d ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return cast_like(out, q.dtype)


def matmul_ref(a, b) -> torch.Tensor:
    """C = A @ B in f32 accumulation."""
    return cast_like(torch.matmul(a.float(), b.float()), a.dtype)
