"""Model assembly for the ten assigned architectures.

One :class:`Model` per ``ArchConfig``; the families share layer code:

  dense / vlm          : [norm -> GQA -> norm -> MLP] blocks
  moe                  : [norm -> GQA/MLA -> norm -> MoE] blocks, after
                         DeepSeek's leading dense layers
  ssm (falcon-mamba)   : [norm -> Mamba] blocks
  hybrid (r.gemma)     : the (RG-LRU, RG-LRU, local attention) pattern:
                         layer i is attention iff i % 3 == 2, every layer
                         has a norm and an MLP after its mixer
  audio (whisper)      : an encoder stack, then a decoder stack with
                         cross-attention onto the encoder's output

The reference stacks each homogeneous stack's weights along a leading
axis and runs ``lax.scan``; here :class:`Model` is an ``nn.Module``
holding one block per layer and loops over them in Python.  Layer i <
``first_dense_layers`` is the reference's ``dense_blocks[i]`` (a SwiGLU
FFN of width ``d_ff``), layer i above it its ``blocks[i -
first_dense_layers]``; whisper's stacks are ``encoder`` and ``decoder``.

Entry points:
  init(generator)             -> fills the weights from a seeded generator
  train_logits(batch)         -> (logits, aux_loss): the summed MoE
                                 load-balancing loss, 0.0 without MoE
  prefill(batch)              -> logits
  init_cache(batch, max_len)  -> the family's decode state, zeros:
                                 {"k", "v"} (L, B, S_max, Hkv, D); MLA
                                 {"c", "kr"}; SSM {"conv", "h"}; hybrid
                                 {"conv", "h", "k", "v"} with the k/v ring
                                 no longer than the window; audio
                                 {"k", "v", "ek", "ev"}
  decode_step(cache, batch)   -> (logits (B,1,V), cache), cache updated in
                                 place

A batch holds ``tokens`` and ``positions`` (B,S); qwen2-vl's M-RoPE reads
``positions3`` (3,B,S) and its vision stub ``vision_embeds`` (B,S,d)
where ``vision_mask`` (B,S) is set; whisper's encoder reads
``audio_embeds`` (B,S_enc,d).  Whisper's decode reads the encoder's K/V
from the cache's ``ek``/``ev``: as in the reference, nothing here builds
them.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, common, mlp, rglru, ssm


def _remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass when
    gradients are on (non-reentrant ``torch.utils.checkpoint``), called
    plainly otherwise."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class Block(nn.Module):
    """[norm1 -> mixer -> norm2 -> FFN].  The mixer is attention (GQA or
    MLA), or with ``recurrent`` the RG-LRU; the FFN is the MoE or, with
    ``dense``, an MLP of width ``d_ff``.  ``cross`` adds a decoder's
    cross-attention (``norm_x`` -> ``cross``) after the mixer."""

    def __init__(self, cfg, dtype, device, dense: bool,
                 recurrent: bool = False, cross: bool = False):
        super().__init__()
        self.norm1 = common.Norm(cfg.d_model, cfg.norm_kind, device)
        if recurrent:
            self.mixer = rglru.RGLRU(cfg, dtype, device)
        elif cfg.mla:
            self.mixer = attention.MLA(cfg, dtype, device)
        else:
            self.mixer = attention.Attention(cfg, dtype, device)
        if cross:
            self.norm_x = common.Norm(cfg.d_model, cfg.norm_kind, device)
            self.cross = attention.Attention(cfg, dtype, device)
        self.norm2 = common.Norm(cfg.d_model, cfg.norm_kind, device)
        if dense:
            # DeepSeek's leading dense layers are SwiGLU whatever mlp_kind
            kind = "swiglu" if cfg.moe else cfg.mlp_kind
            self.ffn = mlp.MLP(cfg.d_model, cfg.d_ff, dtype, kind, device)
        else:
            self.ffn = mlp.MoE(cfg, dtype, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        self.mixer.init_(gen)
        if hasattr(self, "cross"):
            self.cross.init_(gen)
        self.ffn.init_(gen)


class MambaBlock(nn.Module):
    """[norm1 -> Mamba]: the Mamba mixer has its own gated output, and
    the block no FFN."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.norm1 = common.Norm(cfg.d_model, cfg.norm_kind, device)
        self.mixer = ssm.Mamba(cfg, dtype, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        self.mixer.init_(gen)


def is_attention_layer(i: int) -> bool:
    """Whether layer i of a hybrid is a local-attention block."""
    return i % 3 == 2


class Model(nn.Module):
    def __init__(self, cfg, device="cuda"):
        super().__init__()
        dev = common.resolve_device(device)
        self.cfg = cfg
        self.device = dev
        self.dtype = common.DTYPES[cfg.dtype]
        dt = self.dtype
        self.embed = nn.Parameter(
            torch.zeros(cfg.vocab_size, cfg.d_model, dtype=dt, device=dev))
        self.final_norm = common.Norm(cfg.d_model, cfg.norm_kind, dev)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.zeros(cfg.d_model, cfg.vocab_size, dtype=dt,
                            device=dev))
        layers = range(cfg.num_layers)
        if cfg.encoder_decoder:
            self.encoder = nn.ModuleList(
                Block(cfg, dt, dev, dense=True)
                for _ in range(cfg.num_encoder_layers))
            self.enc_norm = common.Norm(cfg.d_model, cfg.norm_kind, dev)
            self.decoder = nn.ModuleList(
                Block(cfg, dt, dev, dense=True, cross=True) for _ in layers)
        elif cfg.ssm:
            self.blocks = nn.ModuleList(MambaBlock(cfg, dt, dev)
                                        for _ in layers)
        elif cfg.hybrid:
            self.blocks = nn.ModuleList(
                Block(cfg, dt, dev, dense=True,
                      recurrent=not is_attention_layer(i))
                for i in layers)
        else:
            dense = cfg.first_dense_layers if cfg.moe else cfg.num_layers
            self.blocks = nn.ModuleList(
                Block(cfg, dt, dev, dense=i < dense) for i in layers)

    # ------------------------------------------------------------- init --
    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "Model":
        """Random weights with the reference's distributions, drawn from
        ``gen`` (which must live on the model's device).  Norm scales
        stay 1, biases (attention, LayerNorm, GELU MLP, conv) 0 and the
        recurrences' constants (``a_log``, ``d_skip``, ``dt_bias``,
        ``ba``, ``bx``, ``lam``) at the reference's values."""
        common.embed_init_(self.embed, gen)
        if not self.cfg.tie_embeddings:
            common.dense_init_(self.lm_head, gen)
        stacks = ((self.encoder, self.decoder) if self.cfg.encoder_decoder
                  else (self.blocks,))
        for stack in stacks:
            for blk in stack:
                blk.init_(gen)
        return self

    # ------------------------------------------------------- embeddings --
    def _embed(self, batch):
        cfg = self.cfg
        x = self.embed[batch["tokens"]]
        if cfg.frontend == "vision" and "vision_embeds" in batch:
            # Modality stub: precomputed patch embeddings replace the
            # token embeddings where the frontend flags them.
            x = torch.where(batch["vision_mask"][..., None],
                            batch["vision_embeds"].to(x.dtype), x)
        if cfg.positional == "sinusoidal":
            x = x + common.sinusoid_at(batch["positions"],
                                       cfg.d_model).to(x.dtype)
        return x

    def _positions(self, batch):
        if self.cfg.positional == "mrope":
            return batch["positions3"]
        return batch["positions"]

    # ------------------------------------------------------------ blocks --
    def _norm(self, p, x):
        return common.apply_norm(p, x, self.cfg.norm_eps)

    def _ffn(self, p, x):
        """The block's FFN on its normed input: (out, MoE aux or None)."""
        if isinstance(p.ffn, mlp.MoE):
            return mlp.moe(p.ffn, self.cfg, x)
        return mlp.mlp(p.ffn, x, p.ffn.kind), None

    def _block_apply(self, p, x, positions, causal=True):
        """One [norm -> attention -> norm -> FFN] block, through the
        config's attention impl; returns (x, aux)."""
        cfg = self.cfg
        h = self._norm(p.norm1, x)
        if cfg.mla:
            att, _ = attention.mla_attention(p.mixer, cfg, h, positions,
                                             causal=causal)
        else:
            att = attention.attention(p.mixer, cfg, h, positions,
                                      causal=causal, impl=cfg.attn_impl)
        x = x + att
        out, aux = self._ffn(p, self._norm(p.norm2, x))
        return x + out, aux

    def _encode(self, batch):
        """Whisper's encoder over ``audio_embeds`` with sinusoidal
        positions 0..S_enc-1; non-causal, through the config's impl."""
        cfg = self.cfg
        enc = batch["audio_embeds"].to(self.dtype)
        frames = torch.arange(enc.shape[1], device=enc.device)
        enc = enc + common.sinusoid_at(frames.expand(enc.shape[:2]),
                                       cfg.d_model).to(enc.dtype)
        for blk in self.encoder:
            enc, _ = _remat(self._block_apply, blk, enc, None, False)
        return self._norm(self.enc_norm, enc)

    def _decoder_block(self, blk, x, positions, enc):
        """One whisper decoder block: self-attention, cross-attention onto
        ``enc``, MLP.  Its attention is always the plain path, as in the
        reference (it passes no impl)."""
        cfg = self.cfg
        x = x + attention.attention(blk.mixer, cfg, self._norm(blk.norm1, x),
                                    positions)
        x = x + attention.attention(blk.cross, cfg,
                                    self._norm(blk.norm_x, x), positions,
                                    causal=False, kv_input=enc)
        return x + self._ffn(blk, self._norm(blk.norm2, x))[0]

    def _mamba_block(self, blk, x):
        return x + ssm.mamba(blk.mixer, self.cfg,
                             self._norm(blk.norm1, x))[0]

    def _lm_head(self, x):
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x @ w

    # ------------------------------------------------------------- train --
    def train_logits(self, batch):
        """Full-sequence forward. Returns (logits (B,S,V), moe_aux_loss):
        the MoE blocks' summed aux losses, 0.0 without MoE.

        Differentiable: with gradients enabled each block of the encoder,
        the decoder, the Mamba stack and the dense and MoE stacks is
        recomputed in the backward pass (``torch.utils.checkpoint``, the
        reference's per-layer ``jax.checkpoint``); the hybrid's blocks are
        not, as in the reference.  No kernel has a backward, so a model
        with ``attn_impl="flash"`` raises when asked for gradients."""
        cfg = self.cfg
        x = self._embed(batch)
        positions = self._positions(batch)
        aux_total = 0.0
        if cfg.encoder_decoder:
            enc = self._encode(batch)
            for blk in self.decoder:
                x = _remat(self._decoder_block, blk, x, positions, enc)
        elif cfg.ssm:
            for blk in self.blocks:
                x = _remat(self._mamba_block, blk, x)
        elif cfg.hybrid:
            for i, blk in enumerate(self.blocks):
                if is_attention_layer(i):
                    x, _ = self._block_apply(blk, x, positions)
                    continue
                x = x + rglru.rglru(blk.mixer, cfg,
                                    self._norm(blk.norm1, x))[0]
                x = x + self._ffn(blk, self._norm(blk.norm2, x))[0]
        else:
            for blk in self.blocks:
                x, aux = _remat(self._block_apply, blk, x, positions)
                if aux is not None:
                    aux_total = aux_total + aux
        x = self._norm(self.final_norm, x)
        return self._lm_head(x), aux_total

    @torch.no_grad()
    def prefill(self, batch):
        """Full-prompt forward returning logits (the reference's prefill
        shares train_logits)."""
        return self.train_logits(batch)[0]

    # ----------------------------------------------------------- serving --
    def init_cache(self, batch_size: int, max_len: int) -> dict:
        cfg = self.cfg
        b, l = batch_size, cfg.num_layers
        kv = (cfg.num_kv_heads, cfg.head_dim)
        f32 = {"h"}                           # recurrent state stays f32
        if cfg.encoder_decoder:
            shapes = {"k": (l, b, max_len) + kv, "v": (l, b, max_len) + kv,
                      "ek": (l, b, cfg.encoder_seq) + kv,
                      "ev": (l, b, cfg.encoder_seq) + kv}
        elif cfg.ssm:
            din = cfg.ssm_expand * cfg.d_model
            shapes = {"conv": (l, b, cfg.ssm_conv - 1, din),
                      "h": (l, b, din, cfg.ssm_state)}
        elif cfg.hybrid:
            w = cfg.lru_width or cfg.d_model
            n_att = sum(is_attention_layer(i) for i in range(l))
            wlen = min(max_len, cfg.sliding_window or max_len)
            shapes = {"conv": (l - n_att, b, rglru.CONV_WIDTH - 1, w),
                      "h": (l - n_att, b, w),
                      "k": (n_att, b, wlen) + kv, "v": (n_att, b, wlen) + kv}
        elif cfg.mla:
            shapes = {"c": (l, b, max_len, cfg.kv_lora_rank),
                      "kr": (l, b, max_len, cfg.qk_rope_dim)}
        else:
            shapes = {"k": (l, b, max_len) + kv, "v": (l, b, max_len) + kv}
        return {k: torch.zeros(s, dtype=torch.float32 if k in f32
                               else self.dtype, device=self.device)
                for k, s in shapes.items()}

    @torch.no_grad()
    def decode_step(self, cache, batch):
        """One-token decode. batch: tokens (B,1), positions (B,1) (and
        positions3 (3,B,1) for M-RoPE).  Writes the token's state into
        ``cache`` in place (k/v, MLA's latent and rope key, the
        recurrences' conv tails and states) and returns (logits (B,1,V),
        cache)."""
        cfg = self.cfg
        x = self._embed(batch)
        positions = self._positions(batch)
        if cfg.encoder_decoder:
            for i, blk in enumerate(self.decoder):
                x = x + attention.decode_attention(
                    blk.mixer, cfg, self._norm(blk.norm1, x), positions,
                    cache["k"][i], cache["v"][i])
                x = x + attention.decode_cross_attention(
                    blk.cross, cfg, self._norm(blk.norm_x, x),
                    cache["ek"][i], cache["ev"][i])
                x = x + self._ffn(blk, self._norm(blk.norm2, x))[0]
        elif cfg.ssm:
            for i, blk in enumerate(self.blocks):
                out, state = ssm.mamba_decode(
                    blk.mixer, cfg, self._norm(blk.norm1, x),
                    (cache["conv"][i], cache["h"][i]))
                self._write_state(cache, i, state)
                x = x + out
        else:
            ia = ir = 0
            for i, blk in enumerate(self.blocks):
                h = self._norm(blk.norm1, x)
                if cfg.hybrid and not is_attention_layer(i):
                    out, state = rglru.rglru_decode(
                        blk.mixer, cfg, h, (cache["conv"][ir],
                                            cache["h"][ir]))
                    self._write_state(cache, ir, state)
                    ir += 1
                elif cfg.mla:
                    out = attention.mla_decode(blk.mixer, cfg, h, positions,
                                               cache["c"][ia],
                                               cache["kr"][ia])
                    ia += 1
                else:
                    out = attention.decode_attention(
                        blk.mixer, cfg, h, positions, cache["k"][ia],
                        cache["v"][ia])
                    ia += 1
                x = x + out
                x = x + self._ffn(blk, self._norm(blk.norm2, x))[0]
        x = self._norm(self.final_norm, x)
        return self._lm_head(x), cache

    @staticmethod
    def _write_state(cache, i, state):
        conv, h = state
        cache["conv"][i].copy_(conv)                        # in place
        cache["h"][i].copy_(h)
