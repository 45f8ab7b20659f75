"""Layer-shape extraction: configs registry -> concrete LayerOp lists (the
port of the reference's ``bridge/shapes.py``).

The bridge walks a model from :mod:`repro_torch.configs.registry` and
builds the port's own block modules (:mod:`repro_torch.models`) on the
``meta`` device, so no parameter memory is ever allocated, and reads
every weight's concrete shape from their ``named_parameters()``.  The
reference asks its ``init_*`` functions through ``jax.eval_shape``
instead; the port's parameter names are the reference's keys (the
converter loads them name for name), and the weights are taken in the
order ``jax.tree_util`` flattens a dict: sorted by key at each level.

Each 2-D weight ``(K, N)`` becomes a GEMM op; each 3-D per-expert weight
``(E, K, N)`` becomes a GEMM op counted once per *active* expert
(``moe_top_k``); attention, Mamba-scan and RG-LRU blocks additionally emit
one dynamic op (``attn`` / ``scan``) for the part of the layer that is not
a weight GEMM.  Non-GEMM parameters (1-D vectors, the SSM ``a_log`` decay
table, the depthwise ``conv_w``) are skipped explicitly.

The workload unit is a **token block** of :data:`TOKEN_BLOCK` tokens: every
GEMM processes TOKEN_BLOCK rows, attention covers a TOKEN_BLOCK-long
context, and recurrences run TOKEN_BLOCK steps.  Lowered tiles cover a
fixed sub-problem; the ratio real-work / tile-work is the op's macro
factor (see :mod:`repro_torch.bridge.lower`).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.configs import registry
from repro_torch.models.attention import MLA, Attention
from repro_torch.models.mlp import MLP, MoE
from repro_torch.models.rglru import RGLRU
from repro_torch.models.ssm import Mamba

#: Tokens processed per workload unit (GEMM M rows, attention context
#: length, recurrence steps).
TOKEN_BLOCK = 128

#: Parameters that are 2-D but not GEMM weights: the SSM decay table and
#: the depthwise conv kernel (its work is a scan-shaped stencil, covered by
#: the layer's scan op), plus anything 1-D.
_SKIP_NAMES = frozenset({"a_log", "conv_w"})

_WHISPER_MELS = 80        # audio frontend: log-mel bins, conv kernel 3
_VISION_PATCH = 3 * 14 * 14   # vision frontend: RGB 14x14 patch embedding


@dataclasses.dataclass(frozen=True)
class LayerOp:
    """One lowered unit of network work.

    ``kind``: ``gemm`` (shape ``(K, N)``: x(M,K) @ W(K,N)), ``attn`` (shape
    ``(heads, head_dim)``) or ``scan`` (shape ``(width,)``: elementwise
    recurrence over ``width`` channels).  ``count`` is how many instances
    the whole network runs per token block (layers x multiplicity).
    """

    kind: str
    label: str
    shape: tuple
    count: int

    @property
    def signature(self) -> tuple:
        """Dedup key: kind + concrete dims.  Label-free on purpose — two
        layers with the same shape lower to the same program."""
        return (self.kind,) + tuple(self.shape)

    @property
    def work(self) -> int:
        """Scalar work per instance (MACs for gemm/attn, element updates
        for scan) at the TOKEN_BLOCK workload unit."""
        if self.kind == "gemm":
            k, n = self.shape
            return TOKEN_BLOCK * k * n
        if self.kind == "attn":
            heads, hd = self.shape
            return 2 * TOKEN_BLOCK * TOKEN_BLOCK * hd * heads
        (width,) = self.shape
        return TOKEN_BLOCK * width


def _weight_shapes(block, *args) -> list[tuple[str, tuple]]:
    """(name, shape) per weight of a block module built on the ``meta``
    device (shapes only, no memory), in ``jax.tree_util``'s flattening
    order of the reference's param dict: sorted by the dotted name's
    parts.  ``name`` is the last part, as the reference labels a leaf."""
    module = block(*args, torch.float32, "meta")
    named = sorted(module.named_parameters(),
                   key=lambda kv: tuple(kv[0].split(".")))
    return [(name.split(".")[-1], tuple(p.shape)) for name, p in named]


def _gemm_ops(prefix: str, weights, count: int, top_k: int) -> list[LayerOp]:
    ops = []
    for name, shape in weights:
        if name in _SKIP_NAMES or len(shape) < 2:
            continue
        if len(shape) == 2:
            k, n = shape
            mult = 1
        elif len(shape) == 3:           # per-expert (E, K, N): top_k active
            _, k, n = shape
            mult = max(1, top_k)
        else:
            continue
        ops.append(LayerOp("gemm", f"{prefix}/{name}", (int(k), int(n)),
                           count * mult))
    return ops


def _head_geometry(cfg) -> tuple[int, int]:
    """(heads, qk head dim) — for MLA the decompressed per-head QK width."""
    hd = cfg.head_dim or cfg.d_model // cfg.num_heads
    if cfg.mla:
        hd = cfg.qk_nope_dim + cfg.qk_rope_dim
    return cfg.num_heads, hd


def _mlp(d, d_ff, kind):
    """An MLP block factory with the reference's ``init_mlp`` arguments."""
    return lambda dtype, device: MLP(d, d_ff, dtype, kind, device)


@functools.lru_cache(maxsize=None)
def model_ops(model: str) -> tuple[LayerOp, ...]:
    """All LayerOps of registry model ``model``, with network-level counts.

    Block composition mirrors :meth:`ArchConfig.param_count`: dense /
    MoE MLPs, (ML)A attention, Mamba blocks, hybrid attention/RG-LRU
    interleave (layer i is attention iff ``i % 3 == 2``), Whisper
    encoder-decoder (decoder layers carry self- plus cross-attention), the
    modality frontend as an im2col GEMM, and the LM head.
    """
    cfg = registry.get(model)
    d, l = cfg.d_model, cfg.num_layers
    ops: list[LayerOp] = []

    # ---- attention / recurrence block mix ------------------------------
    if cfg.ssm:
        ops += _gemm_ops("ssm", _weight_shapes(Mamba, cfg), l, 0)
        din = cfg.ssm_expand * d
        ops.append(LayerOp("scan", "ssm_scan", (din * cfg.ssm_state,), l))
        n_mlp = 0                        # Mamba blocks subsume the MLP
    elif cfg.hybrid:
        n_att = sum(1 for i in range(l) if i % 3 == 2)
        n_rec = l - n_att
        ops += _gemm_ops("attn", _weight_shapes(Attention, cfg), n_att, 0)
        ops.append(LayerOp("attn", "attention", _head_geometry(cfg), n_att))
        ops += _gemm_ops("rglru", _weight_shapes(RGLRU, cfg), n_rec, 0)
        ops.append(LayerOp("scan", "rglru_scan", (cfg.lru_width or d,),
                           n_rec))
        n_mlp = l
    else:
        block_a = MLA if cfg.mla else Attention
        n_att = l + (cfg.num_encoder_layers + l if cfg.encoder_decoder
                     else 0)            # decoder self + cross, encoder self
        ops += _gemm_ops("attn", _weight_shapes(block_a, cfg), n_att, 0)
        ops.append(LayerOp("attn", "attention", _head_geometry(cfg), n_att))
        n_mlp = l + (cfg.num_encoder_layers if cfg.encoder_decoder else 0)

    # ---- MLP / MoE blocks ---------------------------------------------
    if n_mlp:
        dense_mlp = _mlp(d, cfg.d_ff, cfg.mlp_kind)
        if cfg.moe:
            n_dense = cfg.first_dense_layers
            n_moe = n_mlp - n_dense
            if n_dense:
                ops += _gemm_ops("mlp", _weight_shapes(dense_mlp), n_dense,
                                 0)
            ops += _gemm_ops("moe", _weight_shapes(MoE, cfg), n_moe,
                             cfg.moe_top_k)
        else:
            ops += _gemm_ops("mlp", _weight_shapes(dense_mlp), n_mlp, 0)

    # ---- frontend + LM head -------------------------------------------
    if cfg.frontend == "audio":          # two k=3 conv1d layers, im2col
        ops.append(LayerOp("gemm", "frontend/conv1", (_WHISPER_MELS * 3, d),
                           1))
        ops.append(LayerOp("gemm", "frontend/conv2", (d * 3, d), 1))
    elif cfg.frontend == "vision":       # patch embedding, im2col
        ops.append(LayerOp("gemm", "frontend/patch", (_VISION_PATCH, d), 1))
    ops.append(LayerOp("gemm", "lm_head", (d, cfg.vocab_size), 1))
    return tuple(ops)
