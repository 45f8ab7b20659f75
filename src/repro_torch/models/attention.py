"""Attention blocks: GQA/MHA (RoPE, M-RoPE, qk-norm, attention bias,
sliding window, cross-attention) and DeepSeek-V2 Multi-head Latent
Attention (MLA).

Three entry modes share weights:
  * ``attention``: full-sequence attention (train / prefill), through the
    plain-torch ``_sdpa`` (``impl='sdpa'``) or the FlashAttention kernel
    (``impl='flash'``, ``kernels.ops.flash_attention``); with
    ``kv_input`` it is cross-attention onto an encoder's output;
  * ``decode_attention``: one token against a (B, S_max, Hkv, D) KV cache,
    a ring buffer when the cache is no longer than the sliding window;
  * ``decode_cross_attention``: one token against an encoder's K/V.

The kernel takes no mask but the causal one, so like the reference the
``flash`` branch refuses a sliding window and cross-attention; bias and
M-RoPE are applied to q/k/v before the call.  It has no backward: asked
for gradients, the ``flash`` branch raises (training goes through
``sdpa``, as the reference's goes through its plain path).

MLA (``mla_attention``, ``mla_decode``) caches the compressed latent
``c`` (B, S, r) and the shared RoPE key ``kr`` (B, S, dr).  Like the
reference it runs as plain products: its query/key head dim (dn + dr) is
not its value head dim, and the FlashAttention kernel takes one head dim
for q, k and v.

On one card the reference's tensor-parallel KV head expansion is a no-op,
so it has no counterpart here.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import common

NEG_INF = -1e30


class Attention(nn.Module):
    """Projection weights, (d_in, d_out) and applied as ``x @ w``; with
    ``cfg.attn_bias`` the biases ``bq``, ``bk``, ``bv`` (zero at init, as
    in the reference)."""

    def __init__(self, cfg, dtype, device="cuda"):
        super().__init__()
        dev = common.resolve_device(device)
        d, hd = cfg.d_model, cfg.head_dim
        nq, nkv = cfg.num_heads, cfg.num_kv_heads

        def w(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dtype, device=dev))

        self.wq, self.wk, self.wv = w(d, nq * hd), w(d, nkv * hd), \
            w(d, nkv * hd)
        self.wo = w(nq * hd, d)
        if cfg.attn_bias:
            self.bq, self.bk, self.bv = w(nq * hd), w(nkv * hd), w(nkv * hd)
        if cfg.qk_norm:
            self.q_norm = common.Norm(hd, "rms", dev)
            self.k_norm = common.Norm(hd, "rms", dev)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            common.dense_init_(w, gen)


def _project_qkv(p, cfg, x, positions, kv_input=None):
    """Returns q: (B,S,Hq,D), k/v: (B,Skv,Hkv,D), keys and values taken
    from ``kv_input`` (B,Skv,d) if given, else from ``x``.  RoPE
    (positions (B,S)) or M-RoPE (positions (3,B,S)) turns q and k unless
    the keys are an encoder's; ``none`` and ``sinusoidal`` turn nothing."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    kv_src = x if kv_input is None else kv_input
    skv = kv_src.shape[1]
    q, k, v = x @ p.wq, kv_src @ p.wk, kv_src @ p.wv
    if cfg.attn_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, cfg.num_heads, hd)
    k = k.reshape(b, skv, cfg.num_kv_heads, hd)
    v = v.reshape(b, skv, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = common.rmsnorm(p.q_norm, q, cfg.norm_eps)
        k = common.rmsnorm(p.k_norm, k, cfg.norm_eps)
    if kv_input is None and cfg.positional == "rope":
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    elif kv_input is None and cfg.positional == "mrope":
        q = common.apply_mrope(q, positions, cfg.rope_theta)
        k = common.apply_mrope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, *, causal, window=None):
    """Plain attention. q: (B,Sq,Hq,D), k/v: (B,Sk,Hkv,D); the causal
    rule is top-left (query row i sees keys j <= i), and a ``window``
    keeps keys j > i - window."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    groups = hq // hkv
    qg = q.reshape(b, sq, hkv, groups, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) * (d ** -0.5)
    if causal or window is not None:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        masked = torch.zeros((sq, sk), dtype=torch.bool, device=q.device)
        if causal:
            masked |= qpos < kpos
        if window is not None:
            masked |= qpos - kpos >= window
        logits = logits.masked_fill(masked, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def attention(p, cfg, x, positions, *, causal=True, kv_input=None,
              impl="sdpa"):
    """Full-sequence attention (train / prefill). x: (B,S,d); with
    ``kv_input`` (B,Skv,d), non-causal cross-attention onto it."""
    q, k, v = _project_qkv(p, cfg, x, positions, kv_input)
    window = cfg.sliding_window
    if impl == "flash":
        if window is not None or kv_input is not None:
            raise ValueError(
                "the flash kernel takes no sliding window and no "
                "cross-attention (the reference asserts the same); use "
                "impl='sdpa'")
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            raise RuntimeError(
                "the flash kernel has no backward, so it cannot train "
                "(nor can the reference's Pallas kernel); train with "
                "attn_impl='sdpa', or run the forward under no_grad")
        out = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal).transpose(1, 2)
    elif impl == "sdpa":
        out = _sdpa(q, k, v, causal=causal and kv_input is None,
                    window=window)
    else:
        raise ValueError(f"attn impl must be 'sdpa' or 'flash', got {impl!r}")
    b, s = x.shape[:2]
    return out.reshape(b, s, cfg.num_heads * cfg.head_dim) @ p.wo


def decode_attention(p, cfg, x, positions, cache_k, cache_v):
    """One-token decode. x: (B,1,d); cache_k/v: (B,S_max,Hkv,D);
    positions (B,1), or for M-RoPE (3,B,1), whose temporal row picks the
    slot and the causal limit.

    A cache no longer than the sliding window is a ring buffer (slot
    pos % S_max; once it has wrapped, every slot is valid); a longer one
    keeps the window in its mask.  Writes this token's k/v into
    ``cache_k``/``cache_v`` in place (the reference's one-hot blend
    builds new arrays; the values are the same) and returns the
    attention output (B,1,d)."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    tpos = positions[0] if positions.ndim == 3 else positions
    b, _, hkv, d = k.shape
    smax = cache_k.shape[1]
    window = cfg.sliding_window
    ring = window is not None and smax <= window
    slot = tpos[:, 0] % smax if ring else tpos[:, 0].clamp(max=smax - 1)
    rows = torch.arange(b, device=x.device)
    cache_k[rows, slot] = k[:, 0]                      # in place
    cache_v[rows, slot] = v[:, 0]

    groups = cfg.num_heads // hkv
    qg = q.reshape(b, hkv, groups, d)                  # (B,Hkv,G,D) (Sq=1)
    logits = torch.einsum("bhgd,bshd->bhgs", qg.float(),
                          cache_k.float()) * (d ** -0.5)
    kpos = torch.arange(smax, device=x.device)[None, :]
    valid = kpos <= tpos[:, :1]                        # causal up to current
    if ring:
        valid = valid | (tpos[:, :1] >= smax)
    elif window is not None:
        valid = valid & (tpos[:, :1] - kpos < window)
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, cache_v.float())
    out = out.reshape(b, 1, cfg.num_heads * cfg.head_dim).to(x.dtype)
    return out @ p.wo


def decode_cross_attention(p, cfg, x, enc_k, enc_v):
    """One token of enc-dec decode against the encoder's K/V (B,S_enc,
    Hkv,D), computed before the decode; returns (B,1,d)."""
    b = x.shape[0]
    q = x @ p.wq
    if cfg.attn_bias:
        q = q + p.bq
    q = q.reshape(b, 1, cfg.num_heads, cfg.head_dim)
    out = _sdpa(q, enc_k, enc_v, causal=False)
    return out.reshape(b, 1, cfg.num_heads * cfg.head_dim) @ p.wo

# ---------------------------------------------------------------------------
# DeepSeek-V2 Multi-head Latent Attention (MLA).
# ---------------------------------------------------------------------------


class MLA(nn.Module):
    """``wq`` (d, h*(dn+dr)), ``wdkv`` (d, r) compresses, ``wkr`` (d, dr)
    gives the shared RoPE key, ``wuk`` (r, h*dn) and ``wuv`` (r, h*dv)
    expand, ``wo`` (h*dv, d); ``kv_norm`` an f32 RMSNorm of width r."""

    def __init__(self, cfg, dtype, device="cuda"):
        super().__init__()
        dev = common.resolve_device(device)
        d, h, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim

        def w(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dtype, device=dev))

        self.wq, self.wdkv, self.wkr = w(d, h * (dn + dr)), w(d, r), w(d, dr)
        self.wuk, self.wuv = w(r, h * dn), w(r, h * dv)
        self.wo = w(h * dv, d)
        self.kv_norm = common.Norm(r, "rms", dev)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wdkv, self.wkr, self.wuk, self.wuv, self.wo):
            common.dense_init_(w, gen)


def _mla_project(p, cfg, x, positions):
    """q_nope (B,S,h,dn), q_rope (B,S,h,dr) (rope applied), the latent
    c (B,S,r) and the rope key kr (B,S,dr)."""
    b, s, _ = x.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = (x @ p.wq).reshape(b, s, cfg.num_heads, dn + dr)
    q_nope = q[..., :dn]
    q_rope = common.apply_rope(q[..., dn:], positions, cfg.rope_theta)
    c = common.rmsnorm(p.kv_norm, x @ p.wdkv, cfg.norm_eps)
    kr = common.apply_rope((x @ p.wkr)[:, :, None, :], positions,
                           cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c, kr


def mla_attention(p, cfg, x, positions, *, causal=True):
    """Full-sequence MLA: k_nope and v are materialised from the latent.
    Returns (out, (c, kr)), the cache payload a server stores."""
    b, s, _ = x.shape
    h, dn, dr, dv = (cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    q_nope, q_rope, c, kr = _mla_project(p, cfg, x, positions)
    k_nope = (c @ p.wuk).reshape(b, s, h, dn)
    v = (c @ p.wuv).reshape(b, s, h, dv)
    logits = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(),
                           k_nope.float())
              + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), kr.float())
              ) * (dn + dr) ** -0.5
    if causal:
        qpos = torch.arange(s, device=x.device)[:, None]
        kpos = torch.arange(s, device=x.device)[None, :]
        logits = logits.masked_fill(qpos < kpos, NEG_INF)
    probs = torch.softmax(logits, -1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    out = out.reshape(b, s, h * dv).to(x.dtype)
    return out @ p.wo, (c, kr)


def mla_decode(p, cfg, x, positions, cache_c, cache_kr):
    """One-token MLA decode against the latent cache, in the absorbed
    form (q_nope projected into the latent space once).  cache_c:
    (B,S_max,r), cache_kr: (B,S_max,dr); the token's latent and rope key
    are written into them in place (the reference's one-hot blend gives
    the same values).  Returns the attention output (B,1,d)."""
    b = x.shape[0]
    h, dn, dr, dv = (cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    r = cfg.kv_lora_rank
    smax = cache_c.shape[1]
    q_nope, q_rope, c, kr = _mla_project(p, cfg, x, positions)
    slot = positions[:, 0].clamp(max=smax - 1)
    rows = torch.arange(b, device=x.device)
    cache_c[rows, slot] = c[:, 0]                      # in place
    cache_kr[rows, slot] = kr[:, 0]

    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(),
                         p.wuk.reshape(r, h, dn).float())     # (B,h,r)
    logits = (torch.einsum("bhr,bsr->bhs", q_lat, cache_c.float())
              + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                             cache_kr.float())) * (dn + dr) ** -0.5
    valid = torch.arange(smax, device=x.device)[None] <= positions[:, :1]
    logits = logits.masked_fill(~valid[:, None], NEG_INF)
    probs = torch.softmax(logits, -1)
    ctx = torch.einsum("bhs,bsr->bhr", probs, cache_c.float())
    out = torch.einsum("bhr,rhd->bhd", ctx, p.wuv.reshape(r, h, dv).float())
    return out.reshape(b, 1, h * dv).to(x.dtype) @ p.wo
