"""AdamW with mixed precision (bf16 params, f32 master/moments), cosine
schedule, global-norm clipping, and optional error-feedback gradient
compression (int8) — the port of the reference's ``optim/adamw.py``.

The optimizer is a set of plain functions over dicts of tensors keyed by
the model's parameter names (``dict(model.named_parameters())``), with
the reference's arithmetic: plain torch ops under ``torch.no_grad()``,
no fused library optimizer.  Where the reference returns new pytrees,
``apply_updates`` writes the new moments, masters and parameters into the
tensors it was given and returns them: at full width a second copy of
the optimizer state would not fit beside the first.  It also clips and
casts each gradient to f32 one leaf at a time, for the same reason.

On DTensor leaves (a sharded step) each gradient is first placed as its
parameter is, so the moments, masters and parameter update shard by
shard; the global norm sums every shard (``full_tensor`` of the partial
sums).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.runtime import tracing


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_grads: bool = False      # error-feedback int8 compression


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d f32 tensor on the step's
    device): linear warm-up, then cosine decay to ``min_lr``."""
    step = _f32(step, getattr(step, "device", None))
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


@torch.no_grad()
def init_state(params: dict) -> dict:
    """``step`` (int32 0-d), f32 moments ``m`` and ``v`` (zeros) and the
    f32 ``master`` copy of every parameter, on the parameters' device."""
    first = next(iter(params.values()))
    return {
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
        "m": {k: torch.zeros_like(p, dtype=torch.float32)
              for k, p in params.items()},
        "v": {k: torch.zeros_like(p, dtype=torch.float32)
              for k, p in params.items()},
        "master": {k: p.detach().to(torch.float32, copy=True)
                   for k, p in params.items()},
    }


@torch.no_grad()
def init_error_feedback(params: dict) -> dict:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


# ---------------------------------------------------------------------------
# Error-feedback int8 gradient compression: quantise per tensor before the
# cross-pod all-reduce; the residual is fed back into the next step so the
# bias telescopes away.
# ---------------------------------------------------------------------------


def _compress_one(g, e):
    g = g.to(torch.float32) + e
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq, g - deq


@torch.no_grad()
def compress_decompress(g: dict, err: dict) -> tuple[dict, dict]:
    """Simulate int8 quantisation with error feedback.  Returns
    (decompressed grads, new errors)."""
    out = {k: _compress_one(g[k], err[k]) for k in g}
    return ({k: d for k, (d, _) in out.items()},
            {k: e for k, (_, e) in out.items()})


def _full(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value (reducing partial sums); a tensor as is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


@torch.no_grad()
def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(_full(torch.sum(torch.square(x.to(torch.float32))))
                          for x in tree.values()))


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The gradient ``g`` with its parameter's placements (DTensors)."""
    if hasattr(p, "placements") and tuple(g.placements) != tuple(
            p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


@torch.no_grad()
def apply_updates(cfg: OptConfig, state: dict, params: dict, grads: dict,
                  err: dict | None = None):
    """One AdamW step.  Returns (params, state, err, stats), the
    parameters (cast from the new masters to their own dtype), moments,
    masters and errors updated in place; ``stats`` holds ``grad_norm``
    and ``lr`` (0-d f32 tensors)."""
    with tracing.span("repro_torch.optim.update",
                      device=state["step"].device):
        grads = {k: _placed_like(grads[k], p) for k, p in params.items()}
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        if cfg.compress_grads and err is None:
            raise ValueError("compress_grads needs the error-feedback state")

        step = state["step"] + 1
        lr = schedule(cfg, step)
        b1c = 1 - _f32(cfg.b1, step.device) ** step.to(torch.float32)
        b2c = 1 - _f32(cfg.b2, step.device) ** step.to(torch.float32)

        for k, p in params.items():
            g = grads[k].to(torch.float32) * scale
            if cfg.compress_grads:
                g, err[k] = _compress_one(g, err[k])
            m, v, master = state["m"][k], state["v"][k], state["master"][k]
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
            del g
            upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            upd += cfg.weight_decay * master
            master.sub_(lr * upd)
            del upd
            p.copy_(master)
        state["step"] = step
    return params, state, err, {"grad_norm": gnorm, "lr": lr}
