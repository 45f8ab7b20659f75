"""Mamba-1 selective SSM block (falcon-mamba-7b).

The reference runs the time recurrence as a two-level scan: chunks of
``CHUNK = 256`` steps under ``jax.checkpoint``, the sequence padded to a
whole number of chunks.  That is a memory strategy for training (only
chunk boundaries are kept for the backward pass).  The port only runs
forward, so here the recurrence is one torch loop over the sequence's
``s`` steps.  A padded step of the reference has ``dt = 0``, so
``exp(dt * A) = 1`` and ``dt * x * B = 0``: it leaves ``h`` unchanged,
and the loop gives the same outputs and the same final state.  As in the
reference, the (B, d_inner, n) terms are formed inside each step from
the (B, d_inner) / (B, n) per-step projections, so nothing of size S x
d_inner x n is materialised.  Decode is a single recurrence step.

Under a mesh the time loop (``common.scan``) runs on each rank's shard of
batch rows and channels, its state laid out where the reference pins
it; the products around it are pinned where the reference pins them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common


def dt_rank(cfg) -> int:
    return max(cfg.d_model // 16, 1)


class Mamba(nn.Module):
    """``in_x``/``in_z`` (d, din) (separate x and gate projections),
    depthwise ``conv_w`` (K, din) and ``conv_b``, ``x_proj`` (din, r + 2n)
    giving dt's rank-r input and B/C, ``dt_proj`` (r, din), ``out_proj``
    (din, d); ``dt_bias`` (din,), ``a_log`` (din, n) and ``d_skip`` (din,)
    in float32 whatever the model's dtype, as in the reference:
    ``a_log = log(1..n)`` on every channel, ``d_skip`` ones, ``dt_bias``
    zeros."""

    def __init__(self, cfg, dtype, device="cuda"):
        super().__init__()
        dev = common.resolve_device(device)
        d, n = cfg.d_model, cfg.ssm_state
        din = cfg.ssm_expand * d

        def w(*shape, dt=dtype):
            return nn.Parameter(torch.zeros(shape, dtype=dt, device=dev))

        self.in_x, self.in_z = w(d, din), w(d, din)
        self.conv_w, self.conv_b = w(cfg.ssm_conv, din), w(din)
        self.x_proj = w(din, dt_rank(cfg) + 2 * n)
        self.dt_proj = w(dt_rank(cfg), din)
        self.dt_bias = w(din, dt=torch.float32)
        self.a_log = nn.Parameter(torch.log(torch.arange(
            1, n + 1, dtype=torch.float32, device=dev)).expand(din, n)
            .clone())
        self.d_skip = nn.Parameter(torch.ones(din, dtype=torch.float32,
                                              device=dev))
        self.out_proj = w(din, d)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        for w in (self.in_x, self.in_z, self.x_proj, self.dt_proj,
                  self.out_proj):
            common.dense_init_(w, gen)
        z = torch.randn(self.conv_w.shape, generator=gen,
                        device=self.conv_w.device)
        self.conv_w.copy_(0.1 * z)


def _conv1d(p, x, prev_tail=None):
    """Causal depthwise conv along time, then SiLU. x: (B,S,din);
    ``prev_tail`` the last K-1 inputs before x (zeros if None).  Returns
    (out, the last K-1 inputs)."""
    w = p.conv_w                                       # (K, din)
    kk = w.shape[0]
    if prev_tail is None:
        prev_tail = x.new_zeros((x.shape[0], kk - 1, x.shape[2]))
    xp = torch.cat([prev_tail, x], dim=1)              # (B, S+K-1, din)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(kk))
    return F.silu(out + p.conv_b), xp[:, -(kk - 1):]


def _step_projections(p, cfg, xc):
    """Per-step inputs of the recurrence. xc: (B,S,din) -> dt (B,S,din)
    f32, b_t/c_t (B,S,n) f32."""
    n, r = cfg.ssm_state, dt_rank(cfg)
    # Under a mesh the product contracts the channels split over the
    # model axis: reduced here, before dt's bias (split like the
    # channels) is added, since DTensor cannot turn that split bias into
    # a partial sum; every channel shard reads B and C whole anyway.
    proj = common.shard(xc @ p.x_proj, common.BATCH, None, None)
    dt_r, b_t, c_t = proj.split([r, n, n], dim=-1)
    dt = F.softplus((dt_r @ p.dt_proj).float() + p.dt_bias)
    return dt, b_t.float(), c_t.float()


def _recurrence(a, h, dt_t, dtx_t, b_t, c_t):
    """One SSM step; forms the (B,din,n) terms transiently.  a: (din,n)
    (= -exp(a_log)); h: (B,din,n); dt_t and dtx_t = dt * x: (B,din);
    b_t/c_t: (B,n).  Returns (h, y (B,din))."""
    d_a = torch.exp(dt_t[..., None] * a)
    h = torch.addcmul(dtx_t[..., None] * b_t[:, None, :], d_a, h)
    return h, (h @ c_t[..., None])[..., 0]


def _time_loop(cfg, a, dt, dtx, b_t, c_t, h=None):
    """The recurrence over dt's S steps from ``h`` (zeros if None):
    (h, y (B,S,din))."""
    if h is None:
        h = dt.new_zeros((dt.shape[0], dt.shape[2], cfg.ssm_state))

    def step(h, t):
        return _recurrence(a, h, dt[:, t], dtx[:, t], b_t[:, t], c_t[:, t])
    return common.scan(step, h, dt.shape[1])


def mamba(p, cfg, x, state=None):
    """Full-sequence Mamba block. x: (B,S,d); ``state`` = (conv tail
    (B,K-1,din), h (B,din,n) f32) to continue from, or None.  Returns
    (out (B,S,d), (conv tail, h)) for decode continuation."""
    xs, z = x @ p.in_x, x @ p.in_z
    xs = common.shard(xs, common.BATCH, None, common.MODEL)
    z = common.shard(z, common.BATCH, None, common.MODEL)
    xc, new_tail = _conv1d(p, xs, None if state is None else state[0])
    dt, b_t, c_t = _step_projections(p, cfg, xc)
    xc_f = xc.float()
    dtx = dt * xc_f
    a = -torch.exp(p.a_log)                            # (din, n)
    h = None if state is None else common.shard(
        state[1], common.BATCH, common.MODEL, None)
    if common.is_dtensor(dt):
        # Independent per batch row and channel: the time loop runs on
        # each rank's shard, the state laid out (BATCH, MODEL, None) at
        # every step, as the reference pins it (its §Perf H3: unpinned,
        # the layouts alternate across steps).
        seq = common.split_placements(dt, {0: 0, 2: 2})
        state_pl = common.split_placements(dt, {0: 0, 2: 1})
        rows = common.split_placements(dt, {0: 0})
        args = (a, dt, dtx, b_t, c_t) + (() if h is None else (h,))
        pls = (common.split_placements(dt, {2: 0}), seq, seq, rows,
               rows) + (() if h is None else (state_pl,))
        h, ys = common.on_shards(lambda *t: _time_loop(cfg, *t),
                                 (state_pl, seq), args, pls)
    else:
        h, ys = _time_loop(cfg, a, dt, dtx, b_t, c_t, h)
    y = ys + p.d_skip * xc_f
    y = (y * F.silu(z.float())).to(x.dtype)
    y = common.shard(y, common.BATCH, None, common.MODEL)
    return common.shard(y @ p.out_proj, common.BATCH, None, None), \
        (new_tail, h)


def mamba_decode(p, cfg, x, state):
    """Single-token step. x: (B,1,d); state = (conv tail (B,K-1,din),
    h (B,din,n) f32).  Returns (out (B,1,d), (conv tail, h))."""
    conv_tail, h = state
    xs, z = x @ p.in_x, x @ p.in_z
    xc, new_tail = _conv1d(p, xs, conv_tail)
    dt, b_t, c_t = _step_projections(p, cfg, xc)
    xc_f = xc.float()
    a = -torch.exp(p.a_log)
    h, y = _recurrence(a, h, dt[:, 0], dt[:, 0] * xc_f[:, 0], b_t[:, 0],
                       c_t[:, 0])
    y = y[:, None] + p.d_skip * xc_f
    y = (y * F.silu(z.float())).to(x.dtype)
    return common.shard(y @ p.out_proj, common.BATCH, None, None), \
        (new_tail, h)
