"""Convert the reference's configs and parameters into the port's.

Nothing here imports the reference: a config is read through its
dataclass fields and parameters arrive as a nested dict of numpy arrays
(float32, or ``ml_dtypes`` bfloat16), each converted to a tensor of its
own dtype.  bf16 -> f32 -> bf16 is exact, so a converted port model
computes with bit-identical weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import DTYPES

ATTN_IMPLS = {"xla": "sdpa", "pallas": "flash"}


def config_from_jax(cfg) -> ArchConfig:
    """The port's ArchConfig for a reference ArchConfig: same fields, with
    ``attn_impl`` mapped ("xla" -> "sdpa", "pallas" -> "flash")."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(ArchConfig)}
    fields["attn_impl"] = ATTN_IMPLS[fields["attn_impl"]]
    return ArchConfig(**fields)


def _tensor(a) -> torch.Tensor:
    """The leaf as a tensor of its own dtype (float32, or bfloat16 from
    ``ml_dtypes``)."""
    name = np.asarray(a).dtype.name
    if name not in DTYPES:
        raise ValueError(f"leaf dtype {name} is neither float32 nor "
                         "bfloat16")
    return torch.from_numpy(np.array(a, np.float32)).to(DTYPES[name])


def _flatten(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _stacks(cfg) -> dict[str, tuple[str, int, int]]:
    """The reference's stacked subtrees: key -> (the port's module list,
    its first layer there, the number of layers)."""
    if cfg.encoder_decoder:
        return {"encoder": ("encoder", 0, cfg.num_encoder_layers),
                "decoder": ("decoder", 0, cfg.num_layers)}
    if cfg.hybrid:
        return {}                 # a Python list of per-layer dicts
    off = cfg.first_dense_layers if cfg.moe else 0
    return {"dense_blocks": ("blocks", 0, off),
            "blocks": ("blocks", off, cfg.num_layers - off)}


def params_from_jax(cfg, tree) -> dict[str, torch.Tensor]:
    """A port ``Model`` state dict from the reference's param pytree.

    The leading layer axis of each stacked subtree is unstacked into the
    port's module lists: ``dense_blocks[i]`` (DeepSeek's leading dense
    layers, if any) is ``blocks.{i}`` and ``blocks[j]`` is
    ``blocks.{first_dense_layers + j}``; whisper's ``encoder[i]`` and
    ``decoder[i]`` are ``encoder.{i}`` and ``decoder.{i}``.  The hybrid's
    ``blocks`` is already a list, ``blocks[i]`` is ``blocks.{i}``.  Each
    leaf keeps the dtype the reference gave it: the config's, or float32
    for the norms, the MoE router and the recurrences' constants
    (``a_log``, ``dt_bias``, ``d_skip``, ``ba``, ``bx``, ``lam``).  The
    (E, d, ff) expert weights are carried whole."""
    stacks = _stacks(cfg)
    if cfg.hybrid and len(tree["blocks"]) != cfg.num_layers:
        raise ValueError(f"the tree has {len(tree['blocks'])} layers, "
                         f"config has {cfg.num_layers}")
    out = {}
    for name, a in _flatten({k: v for k, v in tree.items()
                             if k not in stacks}):
        out[name] = _tensor(a)
    for key, (dest, start, n) in stacks.items():
        if n and key not in tree:
            raise ValueError(f"config has {n} layers in {key}, the tree "
                             "has none")
        for name, a in _flatten(tree.get(key, {})):
            if a.shape[0] != n:
                raise ValueError(f"{key}.{name} has {a.shape[0]} layers, "
                                 f"config has {n}")
            for i in range(n):
                out[f"{dest}.{start + i}.{name}"] = _tensor(a[i])
    return out
