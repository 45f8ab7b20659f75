"""Model assembly: the dense family ([norm -> GQA -> norm -> MLP] blocks).

The reference stacks each layer's weights along a leading axis and runs
``lax.scan``; here :class:`Model` is an ``nn.Module`` holding one
:class:`Block` per layer and loops over them in Python.

Entry points:
  init(generator)             -> fills the weights from a seeded generator
  train_logits(batch)         -> (logits, aux_loss)
  prefill(batch)              -> logits
  init_cache(batch, max_len)  -> {"k", "v"}: (L, B, S_max, Hkv, D) zeros
  decode_step(cache, batch)   -> (logits (B,1,V), cache), cache updated in
                                 place

Other families (MoE, MLA, SSM, hybrid, encoder-decoder, VLM), and dense
configs with features only those use (attention bias, sliding window,
positions other than RoPE), raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention, common, mlp


class Block(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.norm1 = common.Norm(cfg.d_model, cfg.norm_kind, device)
        self.mixer = attention.Attention(cfg, dtype, device)
        self.norm2 = common.Norm(cfg.d_model, cfg.norm_kind, device)
        self.ffn = mlp.MLP(cfg.d_model, cfg.d_ff, dtype, cfg.mlp_kind,
                           device)


class Model(nn.Module):
    def __init__(self, cfg, device="cuda"):
        super().__init__()
        if (cfg.family != "dense" or cfg.moe or cfg.mla or cfg.attn_bias
                or cfg.sliding_window is not None
                or cfg.positional != "rope"):
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}) is not ported yet; the port has "
                "the dense family (ROADMAP: remaining model families)")
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
        self.blocks = nn.ModuleList(
            Block(cfg, self.dtype, dev) for _ in range(cfg.num_layers))

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

    def _block_apply(self, p, x, positions):
        """One causal [norm -> attention -> norm -> MLP] block."""
        cfg = self.cfg
        x = x + attention.attention(p.mixer, cfg, self._norm(p.norm1, x),
                                    positions, impl=cfg.attn_impl)
        return x + mlp.mlp(p.ffn, self._norm(p.norm2, x), cfg.mlp_kind)

    def _lm_head(self, x):
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x @ w

    # ------------------------------------------------------------- train --
    @torch.no_grad()
    def train_logits(self, batch):
        """Full-sequence forward. batch: tokens (B,S), positions (B,S).
        Returns (logits (B,S,V), moe_aux_loss)."""
        x = self.embed[batch["tokens"]]
        positions = batch["positions"]
        for blk in self.blocks:
            x = self._block_apply(blk, x, positions)
        x = self._norm(self.final_norm, x)
        return self._lm_head(x), 0.0

    def prefill(self, batch):
        """Full-prompt forward returning logits (the reference's prefill
        shares train_logits)."""
        return self.train_logits(batch)[0]

    # ----------------------------------------------------------- serving --
    def init_cache(self, batch_size: int, max_len: int) -> dict:
        cfg = self.cfg
        shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads,
                 cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device)}

    @torch.no_grad()
    def decode_step(self, cache, batch):
        """One-token decode. batch: tokens (B,1), positions (B,1).  Writes
        the token's k/v into ``cache`` in place and returns
        (logits (B,1,V), cache)."""
        cfg = self.cfg
        x = self.embed[batch["tokens"]]
        positions = batch["positions"]
        for i, blk in enumerate(self.blocks):
            x = x + attention.decode_attention(
                blk.mixer, cfg, self._norm(blk.norm1, x), positions,
                cache["k"][i], cache["v"][i])
            x = x + mlp.mlp(blk.ffn, self._norm(blk.norm2, x), cfg.mlp_kind)
        x = self._norm(self.final_norm, x)
        return self._lm_head(x), cache
