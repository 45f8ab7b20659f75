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

    The leading layer axis of ``tree["blocks"]`` is unstacked into
    ``blocks.{i}.*``.  Weights are cast to ``cfg.dtype``; norm parameters
    stay float32, as in both packages."""
    dtype = DTYPES[cfg.dtype]

    def cast(name, a):
        owner = name.split(".")[-2] if "." in name else ""
        return _tensor(a, torch.float32 if "norm" in owner else dtype)

    out = {}
    for name, a in _flatten({k: v for k, v in tree.items()
                             if k != "blocks"}):
        out[name] = cast(name, a)
    for name, a in _flatten(tree["blocks"]):
        if a.shape[0] != cfg.num_layers:
            raise ValueError(f"blocks.{name} has {a.shape[0]} layers, "
                             f"config has {cfg.num_layers}")
        for i in range(cfg.num_layers):
            out[f"blocks.{i}.{name}"] = cast(name, a[i])
    return out
