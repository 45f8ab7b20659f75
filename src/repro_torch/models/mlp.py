"""MLP blocks: SwiGLU / GELU and capacity-based Mixture-of-Experts.

MoE uses group-wise GShard-style routing with a fixed per-group capacity,
as in the reference: routing groups are batch rows, tokens are scattered
into (E, C) expert buffers by a sort-free rank, the expert FFNs run as
batched products and the results are gathered back with the router
weights.  Assignments over capacity are dropped (they fall back to the
residual and the shared experts).  The reference runs every step of it as
plain einsums, outside any Pallas kernel, and so does the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common


class MLP(nn.Module):
    """SwiGLU (``wi``, ``wg``, ``wo``) or GELU (``wi``, ``wo``, ``bi``,
    ``bo``) weights, (d_in, d_out) and applied as ``x @ w``."""

    def __init__(self, d: int, d_ff: int, dtype, kind: str = "swiglu",
                 device="cuda"):
        super().__init__()
        dev = common.resolve_device(device)

        def w(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dtype, device=dev))

        self.kind = kind
        self.wi, self.wo = w(d, d_ff), w(d_ff, d)
        if kind == "swiglu":
            self.wg = w(d, d_ff)
        else:
            self.bi, self.bo = w(d_ff), w(d)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        common.dense_init_(self.wi, gen)
        if self.kind == "swiglu":
            common.dense_init_(self.wg, gen)
        common.dense_init_(self.wo, gen, fan_in=self.wo.shape[0])


def mlp(p, x, kind: str = "swiglu"):
    if kind == "swiglu":
        h = F.silu(x @ p.wg) * (x @ p.wi)
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p.wi + p.bi, approximate="tanh")
    out = h @ p.wo
    if kind != "swiglu":
        out = out + p.bo
    return out


# ---------------------------------------------------------------------------
# Mixture of Experts.
# ---------------------------------------------------------------------------


class MoE(nn.Module):
    """``router`` (d, E) in float32 whatever the model's dtype; expert
    weights ``wi``, ``wg`` (E, d, ff) and ``wo`` (E, ff, d); an optional
    ``shared`` SwiGLU :class:`MLP` of width ``moe_d_ff *
    num_shared_experts``."""

    def __init__(self, cfg, dtype, device="cuda"):
        super().__init__()
        dev = common.resolve_device(device)
        d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff

        def w(*shape, dt=dtype):
            return nn.Parameter(torch.zeros(shape, dtype=dt, device=dev))

        self.router = w(d, e, dt=torch.float32)
        self.wi, self.wg, self.wo = w(e, d, ff), w(e, d, ff), w(e, ff, d)
        if cfg.num_shared_experts:
            self.shared = MLP(d, ff * cfg.num_shared_experts, dtype,
                              "swiglu", dev)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        # As the reference's init: fan_in defaults to shape[0], which is
        # E for the (E, d, ff) weights.
        common.dense_init_(self.router, gen)
        common.dense_init_(self.wi, gen)
        common.dense_init_(self.wg, gen)
        common.dense_init_(self.wo, gen, fan_in=self.wo.shape[1])
        if hasattr(self, "shared"):
            self.shared.init_(gen)


def _dispatch_ranks(expert_ids, num_experts):
    """Per-(token, slot) rank within its expert, computed sort-free.

    expert_ids: (..., T, k).  rank[..., t, j] = the assignments to the
    same expert strictly before flattened position t*k + j of the same
    group (a one-hot exclusive cumsum)."""
    *lead, t, k = expert_ids.shape
    flat = expert_ids.reshape(*lead, t * k)
    onehot = F.one_hot(flat, num_experts)                 # (..., T*k, E)
    ranks = onehot.cumsum(-2) - onehot                    # exclusive
    rank = ranks.gather(-1, flat[..., None])[..., 0]
    return rank.reshape(*lead, t, k)


def route(p, cfg, x):
    """Router probabilities (B, S, E) in f32, and each token's top-k
    gates (renormalised) and expert ids (B, S, k)."""
    probs = torch.softmax(x.float() @ p.router, -1)
    gate, ids = torch.topk(probs, cfg.moe_top_k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gate, ids


def moe(p, cfg, x, capacity_factor: float = 1.25):
    """x: (B, S, d); routing groups are batch rows.  Returns (out, aux):
    out in ``x.dtype``, aux the Switch-style load-balancing loss."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.moe_top_k
    cap = max(int(capacity_factor * s * k / e), 1)

    probs, gate, ids = route(p, cfg, x)
    rank = _dispatch_ranks(ids, e)                        # (B, S, k)
    keep = rank < cap
    # Scatter tokens into (B, E, C, d) buffers.  Kept (expert, rank)
    # pairs are unique; a dropped assignment adds zeros at slot cap - 1.
    rows = torch.arange(b, device=x.device)[:, None, None].expand(b, s, k)
    slot = torch.where(keep, rank, cap - 1)
    tok = torch.where(keep[..., None], x[:, :, None, :],
                      torch.zeros((), dtype=x.dtype, device=x.device))
    buf = x.new_zeros(b, e, cap, d)
    buf.index_put_((rows, ids, slot), tok, accumulate=True)

    h = F.silu(torch.einsum("becd,edf->becf", buf, p.wg))
    h = h * torch.einsum("becd,edf->becf", buf, p.wi)
    out_buf = torch.einsum("becf,efd->becd", h, p.wo)

    w = torch.where(keep, gate, 0.0)                      # (B, S, k)
    gathered = out_buf[rows, ids, rank.clamp(max=cap - 1)]  # (B, S, k, d)
    out = (w[..., None] * gathered.float()).sum(2).to(x.dtype)
    if hasattr(p, "shared"):
        out = out + mlp(p.shared, x, "swiglu")
    density = F.one_hot(ids, e).float().mean((0, 1, 2))
    router_prob = probs.mean((0, 1))
    aux = e * torch.sum(density * router_prob)
    return out, aux
