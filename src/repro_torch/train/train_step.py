"""Training step: microbatched, per-layer recomputed (the port of the
reference's ``train/train_step.py``).

``make_train_step(cfg, opt_cfg, microbatches)`` builds
  (model, opt_state, err, batch) -> (params, opt_state', err', metrics)
where the port's :class:`repro_torch.models.Model` holds the parameters
that the reference passes as a pytree; ``params`` is
``dict(model.named_parameters())``, updated in place.  Each step runs
eagerly (no ``jit``): forward, backward (the model recomputes each
block's activations, as the reference's ``jax.checkpoint`` does), AdamW.
Gradient accumulation over microbatches sums f32 gradients.  The
reference's ``shard_batch_specs`` is a plan for many devices and is not
ported here.
"""

from __future__ import annotations

import torch

from repro_torch.optim import adamw

AUX_WEIGHT = 0.01


def cross_entropy(logits, targets):
    """Token-mean CE in f32 (log-sum-exp); logits (B,S,V)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return (lse - gold).mean()


def make_loss_fn(cfg):
    """loss_fn(model, batch) -> (total, {"loss", "aux"}): the CE plus
    AUX_WEIGHT times the MoE aux loss.  ``cfg`` keeps the reference's
    signature (there it builds the model, which the port passes in)."""

    def loss_fn(model, batch):
        logits, aux = model.train_logits(batch)
        loss = cross_entropy(logits, batch["targets"])
        total = loss + AUX_WEIGHT * aux
        return total, {"loss": loss, "aux": aux}
    return loss_fn


def _split(key, x, microbatches):
    """A batch tensor cut into ``microbatches`` along its batch axis."""
    if key == "positions3":               # (3,B,S) -> (mb, 3, B/mb, S)
        return x.reshape(3, microbatches, -1, x.shape[-1]
                         ).permute(1, 0, 2, 3)
    return x.reshape(microbatches, -1, *x.shape[1:])


def _grads(params: dict) -> dict:
    """Each parameter's gradient (zeros where the loss does not reach
    it, as JAX's would be), taken off the parameter."""
    out = {}
    for k, p in params.items():
        out[k] = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
    return out


def make_train_step(cfg, opt_cfg: adamw.OptConfig, microbatches: int = 1):
    loss_fn = make_loss_fn(cfg)

    def value_and_grad(model, params, batch):
        for p in params.values():
            p.grad = None
        with torch.enable_grad():
            total, metrics = loss_fn(model, batch)
            total.backward()
        metrics = {k: (v.detach() if torch.is_tensor(v)
                       else torch.tensor(v, dtype=torch.float32))
                   for k, v in metrics.items()}
        return metrics, _grads(params)

    def train_step(model, opt_state, err, batch):
        params = dict(model.named_parameters())
        if microbatches == 1:
            metrics, grads = value_and_grad(model, params, batch)
        else:
            mbatches = {k: _split(k, v, microbatches)
                        for k, v in batch.items()}
            grads = {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in params.items()}
            loss_sum = aux_sum = 0.0
            for i in range(microbatches):
                m, g = value_and_grad(
                    model, params, {k: v[i] for k, v in mbatches.items()})
                for k in grads:
                    grads[k] += g[k].to(torch.float32)
                del g
                loss_sum = loss_sum + m["loss"]
                aux_sum = aux_sum + m["aux"]
            for k in grads:
                grads[k] /= microbatches
            metrics = {"loss": loss_sum / microbatches,
                       "aux": aux_sum / microbatches}
        params, opt_state, err, stats = adamw.apply_updates(
            opt_cfg, opt_state, params, grads, err)
        del grads
        metrics.update(stats)
        return params, opt_state, err, metrics

    return train_step
