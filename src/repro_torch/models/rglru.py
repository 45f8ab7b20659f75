"""RG-LRU recurrent block (recurrentgemma-2b), per Griffin (arXiv:2402.19427).

Block = temporal conv1d + gated linear recurrence:
    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    a_t = a ** (c * r_t)                  (a = sigmoid(lambda), c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference runs the recurrence as the same two-level chunked scan as
its Mamba block, padding with ``a = 1``, ``gated = 0`` (steps that leave
``h`` unchanged); here it is one torch loop over the sequence, with the
same outputs and final state (see ``models/ssm.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common

C_EXP = 8.0
CONV_WIDTH = 4


class RGLRU(nn.Module):
    """``in_x``/``in_z`` (d, w), ``conv_w`` (4, w) and ``conv_b``, the
    gate weights ``wa``/``wx`` (w, w), ``out_proj`` (w, d); the gate
    biases ``ba`` (2, toward remembering), ``bx`` (0) and ``lam`` (3,
    a = sigmoid(3) ~ 0.95), (w,) in float32 whatever the model's dtype,
    as in the reference."""

    def __init__(self, cfg, dtype, device="cuda"):
        super().__init__()
        dev = common.resolve_device(device)
        d = cfg.d_model
        w_ = cfg.lru_width or d

        def w(*shape, dt=dtype, fill=0.0):
            return nn.Parameter(torch.full(shape, fill, dtype=dt, device=dev))

        self.in_x, self.in_z = w(d, w_), w(d, w_)
        self.conv_w, self.conv_b = w(CONV_WIDTH, w_), w(w_)
        self.wa, self.wx = w(w_, w_), w(w_, w_)
        self.ba = w(w_, dt=torch.float32, fill=2.0)
        self.bx = w(w_, dt=torch.float32)
        self.lam = w(w_, dt=torch.float32, fill=3.0)
        self.out_proj = w(w_, d)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        for w in (self.in_x, self.in_z, self.wa, self.wx, self.out_proj):
            common.dense_init_(w, gen)
        z = torch.randn(self.conv_w.shape, generator=gen,
                        device=self.conv_w.device)
        self.conv_w.copy_(0.1 * z)


def _conv1d(p, x, prev_tail=None):
    """Causal depthwise conv along time (no activation, unlike Mamba's).
    x: (B,S,w).  Returns (out, the last K-1 inputs)."""
    w = p.conv_w
    kk = w.shape[0]
    if prev_tail is None:
        prev_tail = x.new_zeros((x.shape[0], kk - 1, x.shape[2]))
    xp = torch.cat([prev_tail, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(kk))
    return out + p.conv_b, xp[:, -(kk - 1):]


def _gates(p, xc):
    """xc: (B,S,w) -> a (B,S,w) f32, gated input (B,S,w) f32."""
    xf = xc.float()
    r = torch.sigmoid((xc @ p.wa).float() + p.ba)
    i = torch.sigmoid((xc @ p.wx).float() + p.bx)
    a = torch.exp(C_EXP * r * F.logsigmoid(p.lam))
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i * xf)
    return a, gated


def rglru(p, cfg, x, state=None):
    """Full-sequence RG-LRU. x: (B,S,d); ``state`` = (conv tail (B,3,w),
    h (B,w) f32) to continue from, or None.  Returns (out, (conv tail,
    h))."""
    b, s, _ = x.shape
    xs, z = x @ p.in_x, x @ p.in_z
    xc, new_tail = _conv1d(p, xs, None if state is None else state[0])
    a, gated = _gates(p, xc)
    h = (a.new_zeros((b, a.shape[2])) if state is None else state[1])
    hs = []
    for t in range(s):
        h = torch.addcmul(gated[:, t], a[:, t], h)
        hs.append(h)
    # jax.nn.gelu defaults to the tanh approximation
    y = (torch.stack(hs, dim=1) * F.gelu(z.float(), approximate="tanh"))
    return y.to(x.dtype) @ p.out_proj, (new_tail, h)


def rglru_decode(p, cfg, x, state):
    """Single-token step. x: (B,1,d); state = (conv tail (B,3,w), h (B,w)
    f32).  Returns (out (B,1,d), (conv tail, h))."""
    conv_tail, h = state
    xs, z = x @ p.in_x, x @ p.in_z
    xc, new_tail = _conv1d(p, xs, conv_tail)
    a, gated = _gates(p, xc)
    h = torch.addcmul(gated[:, 0], a[:, 0], h)
    y = h[:, None] * F.gelu(z.float(), approximate="tanh")
    return y.to(x.dtype) @ p.out_proj, (new_tail, h)
