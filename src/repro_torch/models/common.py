"""Shared model components: devices, norms, initializers and RoPE.

The reference's sharding helpers (``shard``, the mesh context and the
decode layout) have no counterpart here: the port runs on one card.
"""

from __future__ import annotations

import math

import torch
from torch import nn

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device) -> torch.device:
    """The device an entry point was asked for.  CUDA is the default of
    every entry point, and a request for it on a machine without a card
    raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale`` + ``bias``) parameters,
    kept in float32 whatever the model's dtype, as in the reference."""

    def __init__(self, d: int, kind: str = "rms", device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.kind = kind
        self.scale = nn.Parameter(torch.ones(d, dtype=torch.float32,
                                             device=dev),
                                  requires_grad=False)
        if kind == "layernorm":
            self.bias = nn.Parameter(torch.zeros(d, dtype=torch.float32,
                                                 device=dev),
                                     requires_grad=False)


def rmsnorm(p, x, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p.scale
    return out.to(x.dtype)


def layernorm(p, x, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * p.scale + p.bias
    return out.to(x.dtype)


def apply_norm(p: Norm, x, eps: float):
    return layernorm(p, x, eps) if p.kind == "layernorm" \
        else rmsnorm(p, x, eps)


# ---------------------------------------------------------------------------
# Initializers: the reference's distributions, drawn from an explicit
# generator on the tensor's device.
# ---------------------------------------------------------------------------


def dense_init_(w: torch.Tensor, gen: torch.Generator, fan_in=None):
    """Fill ``w`` with N(0, 1/fan_in) (fan_in defaults to ``w.shape[0]``)."""
    fan_in = fan_in or w.shape[0]
    z = torch.randn(w.shape, generator=gen, device=w.device)
    w.copy_(z / math.sqrt(fan_in))
    return w


def embed_init_(w: torch.Tensor, gen: torch.Generator):
    """Fill ``w`` (vocab, d) with N(0, 0.02^2)."""
    z = torch.randn(w.shape, generator=gen, device=w.device)
    w.copy_(z * 0.02)
    return w


# ---------------------------------------------------------------------------
# RoPE: split-half rotation (x1 = first half of D, x2 = second half).
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 1e4):
    """x: (B, S, H, D); positions: (B, S) integer."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    ang = positions[..., None].float() * freqs             # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)
