"""Training step: microbatched, per-layer recomputed (the port of the
reference's ``train/train_step.py``).

``make_train_step(cfg, opt_cfg, microbatches)`` builds
  (model, opt_state, err, batch) -> (params, opt_state', err', metrics)
where the port's :class:`repro_torch.models.Model` holds the parameters
that the reference passes as a pytree; ``params`` is
``dict(model.named_parameters())``, updated in place.  Each step runs
eagerly (no ``jit``): forward, backward (the model recomputes each
block's activations, as the reference's ``jax.checkpoint`` does), AdamW.
Gradient accumulation over microbatches sums f32 gradients.

Under a mesh (``models.common.set_mesh``) the same step runs on DTensor
parameters and batches (``launch.sharding``): the model pins its
activations, each gradient is placed as its parameter is, and
``shard_batch_specs`` gives a batch's shardings.
"""

from __future__ import annotations

import torch

from repro_torch.models import common
from repro_torch.optim import adamw
from repro_torch.runtime import tracing

AUX_WEIGHT = 0.01


def cross_entropy(logits, targets):
    """Token-mean CE in f32 (log-sum-exp); logits (B,S,V)."""
    logits = logits.to(torch.float32)
    if common.is_dtensor(logits):
        # The vocab is split over the model axis: reduce each shard's
        # max and exp-sum, and pick each gold logit by a mask (the sum
        # adds exact zeros), so no rank gathers the logits.
        from torch.distributed.tensor import Replicate, Shard, \
            distribute_tensor
        m = logits.amax(-1, keepdim=True).detach()
        lse = (m + torch.log(torch.exp(logits - m).sum(-1, keepdim=True))
               )[..., 0]
        vdim = logits.ndim - 1
        vocab = distribute_tensor(
            torch.arange(logits.shape[-1], device=logits.device),
            logits.device_mesh,
            [Shard(0) if p == Shard(vdim) else Replicate()
             for p in logits.placements], src_data_rank=None)
        gold = torch.where(vocab == targets[..., None], logits, 0.0).sum(-1)
    else:
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
    """A batch tensor cut into ``microbatches`` along its batch axis:
    contiguous blocks of rows, as the reference cuts them.  A DTensor
    batch split over the data axis is cut into every mb-th row instead,
    so each microbatch stays split over it (the same rows in all; the
    mean loss and the summed gradients are the same up to summation
    order, and MoE routes each row on its own)."""
    if common.is_dtensor(x):
        if key == "positions3":           # (3,B,S) -> (mb, 3, B/mb, S)
            return x.reshape(3, -1, microbatches, x.shape[-1]
                             ).permute(2, 0, 1, 3)
        return x.reshape(-1, microbatches, *x.shape[1:]).transpose(0, 1)
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

    calls = 0

    def value_and_grad(model, params, batch):
        for p in params.values():
            p.grad = None
        device = next(iter(params.values())).device
        with torch.enable_grad():
            with tracing.span("repro_torch.train.forward", device=device):
                total, metrics = loss_fn(model, batch)
            with tracing.span("repro_torch.train.backward", device=device):
                total.backward()
                grads = _grads(params)
        metrics = {k: (v.detach() if torch.is_tensor(v)
                       else torch.tensor(v, dtype=torch.float32))
                   for k, v in metrics.items()}
        return metrics, grads

    def train_step(model, opt_state, err, batch):
        nonlocal calls
        calls += 1
        device = next(model.parameters()).device
        with tracing.span("repro_torch.train.step", step=calls - 1), \
                common.sharded():
            allocs = tracing.device_allocs(device)
            out = _train_step(model, opt_state, err, batch)
            if allocs is not None:
                tracing.count("alloc.device_allocs",
                              tracing.device_allocs(device) - allocs)
            return out

    def _train_step(model, opt_state, err, batch):
        params = dict(model.named_parameters())
        if microbatches == 1:
            metrics, grads = value_and_grad(model, params, batch)
        else:
            mbatches = {k: _split(k, v, microbatches)
                        for k, v in batch.items()}
            grads = {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in params.items()}
            sums = {"loss": 0.0, "aux": 0.0}

            def accumulate(i):
                m, g = value_and_grad(
                    model, params, {k: v[i] for k, v in mbatches.items()})
                for k in grads:
                    grads[k] += g[k].to(torch.float32)
                del g
                for k in sums:
                    sums[k] = sums[k] + m[k]
            common.repeat(accumulate, microbatches)
            for k in grads:
                grads[k] /= microbatches
            metrics = {k: v / microbatches for k, v in sums.items()}
        params, opt_state, err, stats = adamw.apply_updates(
            opt_cfg, opt_state, params, grads, err)
        del grads
        metrics.update(stats)
        return params, opt_state, err, metrics

    return train_step


def shard_batch_specs(cfg, mesh):
    """NamedShardings for the input batch (batch dim over pod+data), by
    key."""
    def for_key(k):
        if k == "positions3":
            return common.NamedSharding(mesh, common.spec(
                mesh, None, common.BATCH, None))
        if k in ("vision_embeds", "audio_embeds"):
            return common.NamedSharding(mesh, common.spec(
                mesh, common.BATCH, None, None))
        return common.NamedSharding(mesh, common.spec(mesh, common.BATCH,
                                                      None))
    return for_key
