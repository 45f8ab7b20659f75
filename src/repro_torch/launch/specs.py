"""Input specs for every (arch x shape) dry-run cell: ``meta`` tensors.

The counterpart of the reference's ``ShapeDtypeStruct`` specs: each is a
tensor on the ``meta`` device, with a shape and a dtype and no storage,
so a full-size model and its AdamW state are described without
allocating anything.  Modality frontends are stubs: the specs *are* the
precomputed frame/patch embeddings the stub would produce.
"""

from __future__ import annotations

import torch

from repro_torch.configs import ShapeConfig, get
from repro_torch.models.model import Model
from repro_torch.optim import adamw

I32 = torch.int32
BF16 = torch.bfloat16


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(arch_name: str, shape: ShapeConfig) -> dict:
    cfg = get(arch_name)
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    out = {"tokens": _spec((b, s), I32), "positions": _spec((b, s), I32)}
    if shape.kind == "train":
        out["targets"] = _spec((b, s), I32)
    if cfg.positional == "mrope":
        out["positions3"] = _spec((3, b, s), I32)
    if cfg.frontend == "vision" and shape.kind != "decode":
        out["vision_embeds"] = _spec((b, s, cfg.d_model), BF16)
        out["vision_mask"] = _spec((b, s), torch.bool)
    if cfg.encoder_decoder and shape.kind != "decode":
        out["audio_embeds"] = _spec((b, cfg.encoder_seq, cfg.d_model), BF16)
    return out


def meta_model(arch_name: str) -> Model:
    """The arch's ``Model`` on the ``meta`` device: every parameter a
    shape and a dtype, none allocated."""
    return Model(get(arch_name), device="meta")


def state_specs(arch_name: str):
    """(params, opt): the parameters keyed as ``named_parameters`` names
    them and the AdamW state, all on ``meta``."""
    params = {k: p.detach()
              for k, p in meta_model(arch_name).named_parameters()}
    return params, adamw.init_state(params)


def cache_specs(arch_name: str, shape: ShapeConfig):
    return meta_model(arch_name).init_cache(shape.global_batch,
                                            shape.seq_len)


def input_specs(arch_name: str, shape_name_or_cfg) -> dict:
    """All specs for one cell: train -> params/opt/batch; decode ->
    params/cache/batch."""
    from repro_torch.configs import SHAPES
    shape = (SHAPES[shape_name_or_cfg]
             if isinstance(shape_name_or_cfg, str) else shape_name_or_cfg)
    params, opt = state_specs(arch_name)
    out = {"batch": batch_specs(arch_name, shape), "params": params}
    if shape.kind == "train":
        out["opt"] = opt
    if shape.kind == "decode":
        out["cache"] = cache_specs(arch_name, shape)
    return out
