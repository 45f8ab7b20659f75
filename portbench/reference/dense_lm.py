"""The plain reference of a dense decoder's training: forward, backward
and AdamW in float32 with TF32 off, in plain PyTorch.

The model, as the configuration's source defines it (Phi-3's
``Phi3ForCausalLM`` with separate projections): token embedding; per
layer ``x + attn(rms(x))`` then ``x + mlp(rms(x))``; RMSNorm
``x / sqrt(mean(x^2) + eps) * scale``; rotary positions (split halves,
``rope_theta``); causal attention over the last ``sliding_window`` keys
(the query's own included), scores scaled by ``head_dim ** -0.5``;
SwiGLU ``(silu(x W_gate) * x W_up) W_down``; a final RMSNorm and an
untied output head; the token-mean cross entropy.

The optimizer is AdamW: the global gradient norm clipped to
``clip_norm``, a linear warm-up then cosine decay of the learning rate,
bias-corrected moments, decoupled weight decay on every leaf.

The parameters are what the configuration states: float32 masters
that AdamW updates, and the values the model computes with held in the
configuration's ``torch_dtype`` (``held``), every matrix rounded to it
as it enters its products; the norms' scales stay float32.  Everything
else is computed in float32.  The gradients pass straight through the
rounding to the masters.

It runs in blocks so that it fits one card beside nothing else: the
forward keeps only each layer's input, and the backward recomputes one
layer at a time.  ``q`` rounds every tensor where a bfloat16 model holds
bfloat16: the held weights, the embedding, each projection's output, the
normed and rotated inputs, the attention's output, the residual stream
and the gradients of the held weights (the scores, the softmax and the
loss stay float32, as in the program).  It is the identity here; the
control rounds there to a lower precision.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _same(x):
    return x


def held_as(dtype):
    """Rounding to ``dtype`` as a matrix enters its products, the
    gradient passed straight through; the identity for float32."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if dtype == torch.float32:
        return _same

    def held(w):
        return w + (w.detach().to(dtype).float() - w.detach())
    return held


def is_held(name: str) -> bool:
    """Whether a leaf is a matrix (held in the configuration's dtype)
    rather than a norm's scale (float32)."""
    return not name.endswith("norm")


def rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, pos, theta):
    """x (B, S, H, D), pos (B, S): the two halves of D turned."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = pos[..., None].float() * freqs
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    a, b = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], -1)


def layer(W, i, x, pos, cfg, q=_same, held=_same):
    p = f"layers.{i}."
    B, S, d = x.shape
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, eps, theta = d // H, cfg["rms_norm_eps"], cfg["rope_theta"]

    def proj(h, name):
        return q(h @ q(held(W[p + name])))

    h = q(rms(x, W[p + "attn_norm"], eps))
    qs = q(rope(proj(h, "wq").view(B, S, H, hd), pos, theta))
    k = q(rope(proj(h, "wk").view(B, S, Hkv, hd), pos, theta))
    v = proj(h, "wv").view(B, S, Hkv, hd)
    rep = H // Hkv
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scores = (qs.transpose(1, 2) @ k.permute(0, 2, 3, 1)) * hd ** -0.5
    qi = torch.arange(S, device=x.device)[:, None]
    ki = torch.arange(S, device=x.device)[None, :]
    hidden = ki > qi
    window = cfg.get("sliding_window")
    if window is not None:
        hidden = hidden | (qi - ki >= window)
    scores = scores.masked_fill(hidden, float("-inf"))
    att = q(torch.softmax(scores, -1) @ v.transpose(1, 2))
    x = q(x + proj(att.transpose(1, 2).reshape(B, S, H * hd), "wo"))
    h = q(rms(x, W[p + "mlp_norm"], eps))
    f = q(F.silu(proj(h, "w_gate")) * proj(h, "w_up"))
    return q(x + proj(f, "w_down"))


def _names(cfg, i):
    p = f"layers.{i}."
    return [p + n for n in ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
                            "w_gate", "w_up", "w_down")]


def loss_and_grads(W, tokens, targets, cfg, q=_same, held=_same):
    """The token-mean cross entropy of one batch and every leaf's
    gradient, one layer recomputed at a time."""
    L = cfg["num_hidden_layers"]
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    xs = [q(held(W["embed"][tokens]))]
    with torch.no_grad():
        for i in range(L):
            xs.append(layer(W, i, xs[-1], pos, cfg, q, held))
    grads = {}
    with torch.enable_grad():
        x = xs[-1].detach().requires_grad_(True)
        fn = W["final_norm"].detach().requires_grad_(True)
        head = W["lm_head"].detach().requires_grad_(True)
        logits = q(q(rms(x, fn, cfg["rms_norm_eps"])) @ q(held(head)))
        loss = F.cross_entropy(logits.view(-1, logits.shape[-1]),
                               targets.reshape(-1))
        g, grads["final_norm"], grads["lm_head"] = torch.autograd.grad(
            loss, (x, fn, head))
        del logits
        for i in reversed(range(L)):
            names = _names(cfg, i)
            x = xs[i].detach().requires_grad_(True)
            ws = {n: W[n].detach().requires_grad_(True) for n in names}
            out = layer(ws, i, x, pos, cfg, q, held)
            got = torch.autograd.grad(out, [x] + [ws[n] for n in names], g)
            g = got[0]
            grads.update(zip(names, got[1:]))
            xs[i + 1] = None
            del out, got, ws
    emb = torch.zeros_like(W["embed"])
    emb.index_add_(0, tokens.reshape(-1), g.reshape(-1, g.shape[-1]))
    grads["embed"] = emb
    return float(loss.detach()), grads


def learning_rate(opt: dict, step: int) -> float:
    if step < opt["warmup_steps"]:
        return opt["peak_lr"] * step / max(opt["warmup_steps"], 1)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    return opt["min_lr"] + 0.5 * (opt["peak_lr"] - opt["min_lr"]) * (
        1 + math.cos(math.pi * prog))


def adamw_step(W, grads, m, v, step: int, opt: dict) -> dict:
    """One AdamW step in place; returns the clipped gradients' norms per
    leaf (the gradients as the update sees them)."""
    gnorm = math.sqrt(sum(float((g * g).sum()) for g in grads.values()))
    scale = min(opt["clip_norm"] / max(gnorm, 1e-12), 1.0)
    lr = learning_rate(opt, step)
    b1, b2 = opt["b1"], opt["b2"]
    b1c, b2c = 1 - b1 ** step, 1 - b2 ** step
    norms = {}
    for k, p in W.items():
        g = grads[k] * scale
        norms[k] = float(g.norm())
        m[k].mul_(b1).add_(g, alpha=1 - b1)
        v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (m[k] / b1c) / (torch.sqrt(v[k] / b2c) + opt["eps"])
        upd.add_(p, alpha=opt["weight_decay"])
        p.sub_(upd, alpha=lr)
    return norms


def train_steps(W, batches, cfg: dict, opt: dict, initial, q=_same,
                probe=None, held=None) -> dict:
    """``len(batches)`` training steps from the float32 masters ``W``
    (updated in place).  Returns each step's loss, the first step's
    clipped gradient norm per leaf and, at the flat indices ``probe``
    gives a leaf, its clipped gradient's elements; and after the last
    step each leaf's change norm, of its master (``change_norms``) and
    of its held value (``param_norms``).  ``initial()`` yields the
    starting leaves again as (name, tensor), so no copy of them is held
    through the steps.  ``held`` defaults to the configuration's
    ``torch_dtype``."""
    held = held_as(cfg["torch_dtype"]) if held is None else held
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        m = {k: torch.zeros_like(w) for k, w in W.items()}
        v = {k: torch.zeros_like(w) for k, w in W.items()}
        losses, first, sample = [], None, {}
        for step, (tokens, targets) in enumerate(batches, start=1):
            loss, grads = loss_and_grads(W, tokens, targets, cfg, q, held)
            for k in grads:             # one leaf's copy at a time
                if is_held(k):
                    grads[k] = q(grads[k])
            norms = adamw_step(W, grads, m, v, step, opt)
            del grads
            losses.append(loss)
            if first is None:
                first = norms
                sample = {k: (m[k].view(-1)[i] / (1 - opt["b1"])).cpu()
                          for k, i in (probe or {}).items()}
        del m, v
        change, param = {}, {}
        with torch.no_grad():
            for k, w0 in initial():
                change[k] = float((W[k] - w0.float()).norm())
                now = q(held(W[k])) if is_held(k) else W[k]
                param[k] = float((now - w0.float()).norm())
        return dict(losses=losses, grad_norms=first, grad_sample=sample,
                    change_norms=change, param_norms=param)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
