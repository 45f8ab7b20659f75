"""Parameter / optimizer / batch / cache sharding rules.

2-D sharding ("tensor parallel" on the model axis + FSDP on the data
axis), the reference's rules leaf by leaf: for every parameter the
model-parallel dimension is picked by name-aware rules with
divisibility-aware degradation (``models.common``), and a second
dimension is FSDP-sharded.  Optimizer moments and masters mirror the
parameter specs.

Each rule gives a :class:`~repro_torch.models.common.NamedSharding` (a
spec on a mesh); :func:`place` turns a tensor into a DTensor with its
placements, and :func:`distribute_model` does so for every parameter of
a ``Model``.  The port names a parameter as ``Model.named_parameters``
does (``blocks.3.mixer.wq``): one module per layer, so a layer's leaf
has no stacked dim, and its spec is the reference's stacked spec without
that dim's leading ``None``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import common

# Leaf-name -> (dim roles) AFTER stripping a leading stacked-layer dim.
# Roles: "m" = model axis, "f" = fsdp(data) axis, "-" = replicated.
_RULES_2D = {
    "wq": "fm", "wk": "fm", "wv": "fm", "wo": "mf",
    "wi": "fm", "wg": "fm",
    "in_proj": "fm", "in_x": "fm", "in_z": "fm",
    "out_proj": "mf", "x_proj": "m-", "dt_proj": "-m",
    "wa": "mf", "wx": "mf",
    "wdkv": "f-", "wkr": "f-", "wuk": "-m", "wuv": "-m",
    "router": "--",
    "embed": "mf", "lm_head": "fm",
    "conv_w": "-m", "a_log": "m-",
}
_RULES_3D = {          # MoE expert-stacked weights (E, d, f) / (E, f, d)
    "wi": "mf-", "wg": "mf-", "wo": "m-f",
}
_ROLE_AXIS = {"m": common.MODEL, "f": common.FSDP, "-": None}


def _leaf_spec(name: str, shape, mesh, hybrid: bool = False):
    """The reference's rule for the parameter ``name`` of ``shape``.

    R8: the reference treats every leaf under a ``blocks`` key as stacked
    and drops its first dim from the rule.  recurrentgemma's blocks are a
    Python list of per-layer dicts with no stacked dim, so there the
    reference drops a real dim (``blocks[0].mixer.in_x`` (2560, 2560)
    gets (None, 'model') where rule ``fm`` would give ('data', 'model')).
    With ``hybrid`` the port does the same, so its specs stay the
    reference's."""
    parts = name.split(".")
    leaf = parts[-1]
    shape = tuple(shape)
    stacked = hybrid and parts[0] == "blocks"          # R8
    core = shape[1:] if stacked and len(shape) > 1 else shape
    prefix = [None] * (len(shape) - len(core))

    roles = None
    if len(core) == 3 and leaf in _RULES_3D:
        roles = _RULES_3D[leaf]
    elif len(core) == len(_RULES_2D.get(leaf, "")) and leaf in _RULES_2D:
        roles = _RULES_2D[leaf]

    if roles is not None:
        dims = prefix + [_ROLE_AXIS[r] for r in roles]
    elif len(core) == 1 and core[0] >= 2048:
        dims = prefix + [common.MODEL]          # large vectors (d_skip, ...)
    elif len(core) >= 2:
        # Fallback heuristic: model on the last dim, fsdp on the first.
        dims = prefix + [common.FSDP] + [None] * (len(core) - 2) \
            + [common.MODEL]
    else:
        dims = prefix + [None] * len(core)
    return common.named_sharding(mesh, shape, *dims)


def params_shardings(params: dict, mesh, cfg) -> dict:
    """{name: NamedSharding} for a dict of parameters (or their meta
    stand-ins), keyed as ``Model.named_parameters`` names them."""
    return {k: _leaf_spec(k, p.shape, mesh, cfg.hybrid)
            for k, p in params.items()}


def opt_shardings(opt_shape, params_sh, mesh):
    """Optimizer state mirrors parameter shardings (step replicated)."""
    return {
        "step": common.NamedSharding(mesh, ()),
        "m": params_sh, "v": params_sh, "master": params_sh,
    }


def batch_shardings(batch_shape, mesh, kind: str = "train"):
    if kind == "decode":
        # serving layout: single-token batch replicated (see
        # models.common.set_decode_layout)
        return {k: common.NamedSharding(mesh, ()) for k in batch_shape}
    out = {}
    for k, v in batch_shape.items():
        if k == "positions3":
            out[k] = common.named_sharding(mesh, v.shape, None, common.BATCH,
                                           None)
        elif k in ("vision_embeds", "audio_embeds"):
            out[k] = common.named_sharding(mesh, v.shape, common.BATCH, None,
                                           None)
        else:
            out[k] = common.named_sharding(
                mesh, v.shape, *([common.BATCH] + [None] * (v.ndim - 1)))
    return out


def cache_shardings(cache_shape, mesh):
    """Serving cache: batch->data; long axes (seq / d_inner) -> model."""
    rules = {
        "k": (None, common.BATCH, common.MODEL, None, None),
        "v": (None, common.BATCH, common.MODEL, None, None),
        "ek": (None, common.BATCH, None, common.MODEL, None),
        "ev": (None, common.BATCH, None, common.MODEL, None),
        "c": (None, common.BATCH, common.MODEL, None),
        "kr": (None, common.BATCH, common.MODEL, None),
        "conv": (None, common.BATCH, None, common.MODEL),
        "h": None,  # rank differs: ssm (L,B,din,n) vs hybrid (L,B,w)
    }
    out = {}
    for k, v in cache_shape.items():
        if k == "h":
            dims = ((None, common.BATCH, common.MODEL, None) if v.ndim == 4
                    else (None, common.BATCH, common.MODEL))
        else:
            dims = rules[k]
        out[k] = common.named_sharding(mesh, v.shape, *dims)
    return out


# ---------------------------------------------------------------------------
# Placing tensors.
# ---------------------------------------------------------------------------


def place(t: torch.Tensor, sh: common.NamedSharding):
    """``t`` as a DTensor with ``sh``'s placements on ``sh.mesh``.

    A full tensor that every rank holds alike (a seeded init, a batch) is
    split locally, with no communication.  A ``meta`` tensor stands for
    its shape only: each rank's local shard is a ``meta`` tensor of the
    shard's shape (the dry run's case)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if t.is_meta:
        local = torch.empty(sh.shard_shape(t.shape), dtype=t.dtype,
                            device=t.device)
        return DTensor.from_local(local, sh.mesh, sh.placements,
                                  run_check=False, shape=t.shape,
                                  stride=torch.empty(t.shape,
                                                     device="meta").stride())
    return distribute_tensor(t.detach(), sh.mesh, sh.placements,
                             src_data_rank=None)


def place_tree(tree, shardings):
    """:func:`place` over a nested dict, each leaf with the sharding at
    its key."""
    return {k: (place_tree(v, shardings[k]) if isinstance(v, dict)
                else place(v, shardings[k]))
            for k, v in tree.items()}


@torch.no_grad()
def distribute_model(model: nn.Module, shardings: dict) -> nn.Module:
    """Replace each parameter of ``model`` by a DTensor parameter placed
    by ``shardings[name]`` (in place; returns ``model``)."""
    for name, p in list(model.named_parameters()):
        *path, leaf = name.split(".")
        module = model.get_submodule(".".join(path))
        setattr(module, leaf, nn.Parameter(place(p, shardings[name]),
                                           requires_grad=p.requires_grad))
    return model
