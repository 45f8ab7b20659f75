"""Convert the reference's configs and parameters into the port's.

Nothing here imports the reference: a config is read through its
dataclass fields and parameters arrive as a nested dict of numpy arrays
(float32, or ``ml_dtypes`` bfloat16).  bf16 -> f32 -> bf16 is exact, so a
converted port model computes with bit-identical weights.
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


def _tensor(a, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def params_from_jax(cfg, tree) -> dict[str, torch.Tensor]:
    """A port ``Model`` state dict from the reference's param pytree.

    The leading layer axis of ``tree["dense_blocks"]`` (DeepSeek's
    leading dense layers, if any) and of ``tree["blocks"]`` is unstacked
    into the port's one numbering: ``dense_blocks[i]`` is ``blocks.{i}``
    and ``blocks[j]`` is ``blocks.{first_dense_layers + j}``.  Weights are
    cast to ``cfg.dtype``; norm parameters and the MoE router stay
    float32, as in both packages, and the (E, d, ff) expert weights are
    carried whole."""
    dtype = DTYPES[cfg.dtype]

    def cast(name, a):
        *owner, leaf = name.split(".")
        f32 = bool(owner) and "norm" in owner[-1] or leaf == "router"
        return _tensor(a, torch.float32 if f32 else dtype)

    off = cfg.first_dense_layers if cfg.moe else 0
    stacks = {"dense_blocks": (0, off),
              "blocks": (off, cfg.num_layers - off)}
    out = {}
    for name, a in _flatten({k: v for k, v in tree.items()
                             if k not in stacks}):
        out[name] = cast(name, a)
    for key, (start, n) in stacks.items():
        if n and key not in tree:
            raise ValueError(f"config has {n} layers in {key}, the tree "
                             "has none")
        for name, a in _flatten(tree.get(key, {})):
            if a.shape[0] != n:
                raise ValueError(f"{key}.{name} has {a.shape[0]} layers, "
                                 f"config has {n}")
            for i in range(n):
                out[f"blocks.{start + i}.{name}"] = cast(name, a[i])
    return out
