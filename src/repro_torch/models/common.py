"""Shared model components: norms, initializers, RoPE and M-RoPE, and
sinusoidal positions.

The reference's sharding helpers (``shard``, the mesh context and the
decode layout) have no counterpart here: the port runs on one card.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
                                             device=dev))
        if kind == "layernorm":
            self.bias = nn.Parameter(torch.zeros(d, dtype=torch.float32,
                                                 device=dev))


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


MROPE_FRACS = (0.25, 0.375, 0.375)        # temporal / height / width sections


def apply_mrope(x, positions3, theta: float = 1e4):
    """Qwen2-VL multimodal RoPE. x: (B,S,H,D); positions3: (3,B,S).  The
    rotation's D/2 frequencies are split into temporal, height and width
    sections, each turned by its own row of ``positions3``."""
    d = x.shape[-1]
    half = d // 2
    sec = [int(half * f) for f in MROPE_FRACS]
    sec[-1] = half - sec[0] - sec[1]
    freqs = rope_freqs(d, theta, x.device)                 # (half,)
    parts, start = [], 0
    for i, n in enumerate(sec):
        parts.append(positions3[i][..., None].float()
                     * freqs[start:start + n])             # (B,S,n)
        start += n
    ang = torch.cat(parts, -1)[:, :, None, :]              # (B,S,1,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Sinusoidal positions (Whisper).
# ---------------------------------------------------------------------------


def sinusoidal_positions(seq: int, d: int) -> torch.Tensor:
    """The (seq, d) table of positions 0..seq-1, computed in float64 and
    returned as float32."""
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    out = np.concatenate([np.sin(ang), np.cos(ang)], -1)
    return torch.from_numpy(out).float()


def sinusoid_at(positions, d: int):
    """Sinusoidal embeddings for integer positions (B,S) -> (B,S,d) f32,
    computed in float32 as the model's embedding adds them."""
    i = torch.arange(d // 2, dtype=torch.float32, device=positions.device)
    inv = torch.pow(10000.0, -2.0 * i / d)
    ang = positions[..., None].float() * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)
