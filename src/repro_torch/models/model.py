"""Model assembly: the dense family ([norm -> GQA -> norm -> MLP] blocks)
and the MoE family ([norm -> GQA/MLA -> norm -> MoE] blocks, after
DeepSeek's leading dense layers).

The reference stacks each layer's weights along a leading axis and runs
``lax.scan``; here :class:`Model` is an ``nn.Module`` holding one
:class:`Block` per layer and loops over them in Python.  Layer i <
``first_dense_layers`` is the reference's ``dense_blocks[i]`` (a SwiGLU
FFN of width ``d_ff``), layer i above it its ``blocks[i -
first_dense_layers]``.

Entry points:
  init(generator)             -> fills the weights from a seeded generator
  train_logits(batch)         -> (logits, aux_loss): the summed MoE
                                 load-balancing loss, 0.0 without MoE
  prefill(batch)              -> logits
  init_cache(batch, max_len)  -> {"k", "v"}: (L, B, S_max, Hkv, D) zeros,
                                 or for MLA {"c": (L, B, S_max, r),
                                 "kr": (L, B, S_max, dr)}
  decode_step(cache, batch)   -> (logits (B,1,V), cache), cache updated in
                                 place

Other families (SSM, hybrid, encoder-decoder, VLM), and configs with
features only those use (attention bias, sliding window, positions other
than RoPE), raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention, common, mlp


class Block(nn.Module):
    """[norm -> attention (GQA or MLA) -> norm -> FFN]; the FFN is the
    MoE, or with ``dense`` an MLP of width ``d_ff``."""

    def __init__(self, cfg, dtype, device, dense: bool):
        super().__init__()
        self.norm1 = common.Norm(cfg.d_model, cfg.norm_kind, device)
        self.mixer = (attention.MLA(cfg, dtype, device) if cfg.mla
                      else attention.Attention(cfg, dtype, device))
        self.norm2 = common.Norm(cfg.d_model, cfg.norm_kind, device)
        if dense:
            # DeepSeek's leading dense layers are SwiGLU whatever mlp_kind
            kind = "swiglu" if cfg.moe else cfg.mlp_kind
            self.ffn = mlp.MLP(cfg.d_model, cfg.d_ff, dtype, kind, device)
        else:
            self.ffn = mlp.MoE(cfg, dtype, device)


class Model(nn.Module):
    def __init__(self, cfg, device="cuda"):
        super().__init__()
        if (cfg.family not in ("dense", "moe") or cfg.ssm or cfg.hybrid
                or cfg.encoder_decoder or cfg.attn_bias
                or cfg.sliding_window is not None
                or cfg.positional != "rope"):
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}) is not ported yet; the port has "
                "the dense and MoE families (ROADMAP: remaining model "
                "families)")
        dev = common.resolve_device(device)
        self.cfg = cfg
        self.device = dev
        self.dtype = common.DTYPES[cfg.dtype]
        self.embed = nn.Parameter(
            torch.zeros(cfg.vocab_size, cfg.d_model, dtype=self.dtype,
                        device=dev), requires_grad=False)
        self.final_norm = common.Norm(cfg.d_model, cfg.norm_kind, dev)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.zeros(cfg.d_model, cfg.vocab_size, dtype=self.dtype,
                            device=dev), requires_grad=False)
        dense = cfg.first_dense_layers if cfg.moe else cfg.num_layers
        self.blocks = nn.ModuleList(
            Block(cfg, self.dtype, dev, dense=i < dense)
            for i in range(cfg.num_layers))

    # ------------------------------------------------------------- init --
    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "Model":
        """Random weights with the reference's distributions, drawn from
        ``gen`` (which must live on the model's device).  Norm scales
        stay 1 and biases (LayerNorm, GELU MLP) 0."""
        common.embed_init_(self.embed, gen)
        if not self.cfg.tie_embeddings:
            common.dense_init_(self.lm_head, gen)
        for blk in self.blocks:
            blk.mixer.init_(gen)
            blk.ffn.init_(gen)
        return self

    # ------------------------------------------------------------ blocks --
    def _norm(self, p, x):
        return common.apply_norm(p, x, self.cfg.norm_eps)

    def _ffn(self, p, x):
        """The block's FFN on its normed input: (out, MoE aux or None)."""
        if isinstance(p.ffn, mlp.MoE):
            return mlp.moe(p.ffn, self.cfg, x)
        return mlp.mlp(p.ffn, x, p.ffn.kind), None

    def _block_apply(self, p, x, positions):
        """One causal [norm -> attention -> norm -> FFN] block; returns
        (x, aux)."""
        cfg = self.cfg
        h = self._norm(p.norm1, x)
        if cfg.mla:
            att, _ = attention.mla_attention(p.mixer, cfg, h, positions)
        else:
            att = attention.attention(p.mixer, cfg, h, positions,
                                      impl=cfg.attn_impl)
        x = x + att
        out, aux = self._ffn(p, self._norm(p.norm2, x))
        return x + out, aux

    def _lm_head(self, x):
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x @ w

    # ------------------------------------------------------------- train --
    @torch.no_grad()
    def train_logits(self, batch):
        """Full-sequence forward. batch: tokens (B,S), positions (B,S).
        Returns (logits (B,S,V), moe_aux_loss): the MoE blocks' summed
        aux losses, 0.0 for a dense model."""
        x = self.embed[batch["tokens"]]
        positions = batch["positions"]
        aux_total = 0.0
        for blk in self.blocks:
            x, aux = self._block_apply(blk, x, positions)
            if aux is not None:
                aux_total = aux_total + aux
        x = self._norm(self.final_norm, x)
        return self._lm_head(x), aux_total

    def prefill(self, batch):
        """Full-prompt forward returning logits (the reference's prefill
        shares train_logits)."""
        return self.train_logits(batch)[0]

    # ----------------------------------------------------------- serving --
    def init_cache(self, batch_size: int, max_len: int) -> dict:
        cfg = self.cfg
        lead = (cfg.num_layers, batch_size, max_len)
        if cfg.mla:
            shapes = {"c": lead + (cfg.kv_lora_rank,),
                      "kr": lead + (cfg.qk_rope_dim,)}
        else:
            kv = lead + (cfg.num_kv_heads, cfg.head_dim)
            shapes = {"k": kv, "v": kv}
        return {k: torch.zeros(s, dtype=self.dtype, device=self.device)
                for k, s in shapes.items()}

    @torch.no_grad()
    def decode_step(self, cache, batch):
        """One-token decode. batch: tokens (B,1), positions (B,1).  Writes
        the token's k/v (MLA: latent and rope key) into ``cache`` in place
        and returns (logits (B,1,V), cache)."""
        cfg = self.cfg
        x = self.embed[batch["tokens"]]
        positions = batch["positions"]
        for i, blk in enumerate(self.blocks):
            h = self._norm(blk.norm1, x)
            if cfg.mla:
                x = x + attention.mla_decode(blk.mixer, cfg, h, positions,
                                             cache["c"][i], cache["kr"][i])
            else:
                x = x + attention.decode_attention(
                    blk.mixer, cfg, h, positions, cache["k"][i],
                    cache["v"][i])
            x = x + self._ffn(blk, self._norm(blk.norm2, x))[0]
        x = self._norm(self.final_norm, x)
        return self._lm_head(x), cache
