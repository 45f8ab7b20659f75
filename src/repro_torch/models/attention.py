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

Under a mesh (``common.set_mesh``) every activation is pinned where the
reference pins it (``common.shard``), and in train/prefill the GQA KV
heads are expanded in the weight view as far as the model axis needs
(:func:`kv_repeat`: the reference's §Perf H1/H5), which changes FLOPs
and placements, not values.  The ``flash`` branch then runs K5 on each
rank's local shard (``local_map``): attention is independent per batch
row and head, which are the only dims the mesh splits there.  Decode
writes the token's k/v into a sharded cache by the reference's one-hot
blend (the same values as the in-place write of the single-card path).
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


def kv_repeat(cfg, tp: int) -> int:
    """How far train/prefill expands the KV heads on a ``tp``-way model
    axis: the smallest divisor r of the GQA group with Hkv * r divisible
    by tp (1 if the heads already divide, or if no divisor does: e.g. 28
    or 10 heads on a 16-way axis, which shard on feature dims instead)."""
    hkv = cfg.num_kv_heads
    groups = cfg.num_heads // hkv
    if groups > 1 and hkv % tp != 0:
        return next((r for r in range(1, groups + 1)
                     if groups % r == 0 and (hkv * r) % tp == 0), 1)
    return 1


def _project_qkv(p, cfg, x, positions, kv_input=None,
                 expand_kv: bool = False):
    """Returns q: (B,S,Hq,D), k/v: (B,Skv,Hkv',D), keys and values taken
    from ``kv_input`` (B,Skv,d) if given, else from ``x``.  RoPE
    (positions (B,S)) or M-RoPE (positions (3,B,S)) turns q and k unless
    the keys are an encoder's; ``none`` and ``sinusoidal`` turn nothing.

    Hkv' is Hkv, or with ``expand_kv`` under a mesh Hkv * kv_repeat: the
    KV weights repeated over the group axis, so k/v shard by heads on the
    model axis (backprop sums the repeats' gradients, keeping GQA
    exact)."""
    b, s, _ = x.shape
    d, hd = cfg.d_model, cfg.head_dim
    hkv = cfg.num_kv_heads
    kv_src = x if kv_input is None else kv_input
    skv = kv_src.shape[1]
    mesh = common.get_mesh()
    tp = 1 if mesh is None else common.axis_sizes(mesh).get(common.MODEL, 1)
    rep = kv_repeat(cfg, tp) if expand_kv else 1
    q = x @ p.wq
    if rep > 1:
        # Hkv does not divide over the model axis (that is why it is
        # expanded), so neither the weights' model split nor, in the
        # backward pass, the expanded gradient's survives the reshapes
        # between Hkv and Hkv * rep heads: each side is gathered over the
        # model axis there, as XLA's partitioner must.
        wk, wv = (common.shard(common.shard(w, common.FSDP, None).reshape(
            d, hkv, hd).repeat_interleave(rep, dim=1), common.FSDP, None,
            None) for w in (p.wk, p.wv))
        wk = common.shard(wk, common.FSDP, common.MODEL, None)
        wv = common.shard(wv, common.FSDP, common.MODEL, None)
        k = torch.einsum("bsd,dhe->bshe", kv_src, wk).reshape(b, skv, -1)
        v = torch.einsum("bsd,dhe->bshe", kv_src, wv).reshape(b, skv, -1)
        if cfg.attn_bias:
            k = k + p.bk.reshape(hkv, hd).repeat_interleave(rep, 0
                                                            ).reshape(-1)
            v = v + p.bv.reshape(hkv, hd).repeat_interleave(rep, 0
                                                            ).reshape(-1)
    else:
        k, v = kv_src @ p.wk, kv_src @ p.wv
        if cfg.attn_bias:
            k, v = k + p.bk, v + p.bv
    if cfg.attn_bias:
        q = q + p.bq
    q = common.split_heads(q, cfg.num_heads, hd)
    k = common.split_heads(k, hkv * rep, hd)
    v = common.split_heads(v, hkv * rep, hd)
    q = common.shard(q, common.BATCH, None, common.MODEL, None)
    k = common.shard(k, common.BATCH, None, common.MODEL, None)
    v = common.shard(v, common.BATCH, None, common.MODEL, None)
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


def _sdpa_local(q, k, v, causal, window):
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


def _local_layout(q, *others):
    """Per mesh dim, where attention on (B,S,H,D) ``q`` and ``others``
    runs shard by shard: split by batch rows if q is, by heads if q is
    and every head count divides the mesh dim (so each shard's q heads
    meet their own k/v heads), else whole."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for n, pl in zip(q.device_mesh.shape, q.placements):
        heads = pl == Shard(2) and all(t.shape[2] % n == 0
                                       for t in (q,) + others)
        out.append(pl if pl == Shard(0) or heads else Replicate())
    return out


def _sdpa(q, k, v, *, causal, window=None):
    """Plain attention. q: (B,Sq,Hq,D), k/v: (B,Sk,Hkv,D); the causal
    rule is top-left (query row i sees keys j <= i), and a ``window``
    keeps keys j > i - window.  DTensors run it shard by shard
    (:func:`_local_layout`): attention is independent per batch row and
    head."""
    if not common.is_dtensor(q):
        return _sdpa_local(q, k, v, causal, window)
    pl = _local_layout(q, k, v)
    return common.on_shards(
        lambda q, k, v: _sdpa_local(q, k, v, causal, window), pl,
        (q, k, v), (pl, pl, pl))


def _flash(q, k, v, causal: bool):
    """K5 on (B,S,H,D) q/k/v; DTensors run it on each rank's local shard
    (``local_map``), which holds whole rows and heads, so each rank's
    call is the single-card call on its part.  A layout that splits the
    sequence or the head dim, holds a partial sum, or splits q's heads
    otherwise than k/v's cannot run locally and raises."""
    def run(q, k, v):
        return ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal).transpose(1, 2)

    if not common.is_dtensor(q):
        return run(q, k, v)
    from torch.distributed.tensor import Replicate, Shard
    ok = (Replicate(), Shard(0), Shard(2))
    if any(not common.is_dtensor(t) or tuple(t.placements) != tuple(
            q.placements) for t in (k, v)) or any(
                pl not in ok for pl in q.placements):
        raise ValueError(
            "flash under a mesh runs on local shards of whole batch rows "
            "and heads, with q and k/v split alike; got q "
            f"{tuple(q.placements)}, k {getattr(k, 'placements', None)}, "
            f"v {getattr(v, 'placements', None)}")
    pl = list(q.placements)
    return common.on_shards(run, pl, (q, k, v), (pl, pl, pl))


def attention(p, cfg, x, positions, *, causal=True, kv_input=None,
              impl="sdpa"):
    """Full-sequence attention (train / prefill). x: (B,S,d); with
    ``kv_input`` (B,Skv,d), non-causal cross-attention onto it."""
    q, k, v = _project_qkv(p, cfg, x, positions, kv_input, expand_kv=True)
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
        out = _flash(q, k, v, causal)
    elif impl == "sdpa":
        out = _sdpa(q, k, v, causal=causal and kv_input is None,
                    window=window)
    else:
        raise ValueError(f"attn impl must be 'sdpa' or 'flash', got {impl!r}")
    out = common.merge_heads(out) @ p.wo
    return common.shard(out, common.BATCH, None, None)


def write_slot(cache, slot, new) -> None:
    """``cache[b, slot[b]] = new[b]`` for every row b, in place.  On a
    DTensor cache it is the reference's one-hot blend, written back by
    ``copy_``: the same values, in ops that run on the cache's shards."""
    if not common.is_dtensor(cache):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, slot] = new
        return
    oh = (torch.arange(cache.shape[1], device=cache.device)[None]
          == slot[:, None]).to(cache.dtype)
    oh = oh.reshape(oh.shape + (1,) * (cache.ndim - 2))
    cache.copy_(cache * (1 - oh) + oh * new[:, None])


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
    # Flash-decode sharding (the reference's §Perf H2): the per-token
    # q/k/v are tiny; replicated over the model axis, attention against
    # the sequence-sharded cache is a local partial softmax plus small
    # all-reduces.
    q = common.shard(q, common.BATCH, None, None, None)
    k = common.shard(k, common.BATCH, None, None, None)
    v = common.shard(v, common.BATCH, None, None, None)
    tpos = positions[0] if positions.ndim == 3 else positions
    b, _, hkv, d = k.shape
    smax = cache_k.shape[1]
    window = cfg.sliding_window
    ring = window is not None and smax <= window
    slot = tpos[:, 0] % smax if ring else tpos[:, 0].clamp(max=smax - 1)
    write_slot(cache_k, slot, k[:, 0])                 # in place
    write_slot(cache_v, slot, v[:, 0])

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
    out = common.merge_heads(out.reshape(b, 1, cfg.num_heads, d)
                             ).to(x.dtype)
    return common.shard(out @ p.wo, common.BATCH, None, None)


def decode_cross_attention(p, cfg, x, enc_k, enc_v):
    """One token of enc-dec decode against the encoder's K/V (B,S_enc,
    Hkv,D), computed before the decode; returns (B,1,d)."""
    b = x.shape[0]
    q = x @ p.wq
    if cfg.attn_bias:
        q = q + p.bq
    q = common.split_heads(q, cfg.num_heads, cfg.head_dim)
    out = _sdpa(q, enc_k, enc_v, causal=False)
    out = common.merge_heads(out) @ p.wo
    return common.shard(out, common.BATCH, None, None)

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
    q = common.split_heads(x @ p.wq, cfg.num_heads, dn + dr)
    q_nope = q[..., :dn]
    q_rope = common.apply_rope(q[..., dn:], positions, cfg.rope_theta)
    c = common.rmsnorm(p.kv_norm, x @ p.wdkv, cfg.norm_eps)
    kr = common.apply_rope((x @ p.wkr)[:, :, None, :], positions,
                           cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c, kr


def _mla_core(q_nope, q_rope, kr, k_nope, v, *, causal, scale):
    """The attention of MLA on materialised heads: (B,S,h,dv) f32."""
    s = q_nope.shape[1]
    logits = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(),
                           k_nope.float())
              + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), kr.float())
              ) * scale
    if causal:
        qpos = torch.arange(s, device=q_nope.device)[:, None]
        kpos = torch.arange(s, device=q_nope.device)[None, :]
        logits = logits.masked_fill(qpos < kpos, NEG_INF)
    probs = torch.softmax(logits, -1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float())


def mla_attention(p, cfg, x, positions, *, causal=True):
    """Full-sequence MLA: k_nope and v are materialised from the latent.
    Returns (out, (c, kr)), the cache payload a server stores.
    DTensors run the attention shard by shard, as :func:`_sdpa` does
    (the shared rope key ``kr`` whole over the head split)."""
    h, dn, dr, dv = (cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    q_nope, q_rope, c, kr = _mla_project(p, cfg, x, positions)
    k_nope = common.split_heads(c @ p.wuk, h, dn)
    v = common.split_heads(c @ p.wuv, h, dv)
    scale = (dn + dr) ** -0.5
    if common.is_dtensor(q_nope):
        from torch.distributed.tensor import Replicate, Shard
        pl = _local_layout(q_nope, q_rope, k_nope, v)
        kr_pl = [Replicate() if at == Shard(2) else at for at in pl]
        out = common.on_shards(
            lambda *t: _mla_core(*t, causal=causal, scale=scale), pl,
            (q_nope, q_rope, kr, k_nope, v), (pl, pl, kr_pl, pl, pl))
    else:
        out = _mla_core(q_nope, q_rope, kr, k_nope, v, causal=causal,
                        scale=scale)
    out = common.merge_heads(out).to(x.dtype) @ p.wo
    return common.shard(out, common.BATCH, None, None), (c, kr)


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
    write_slot(cache_c, slot, c[:, 0])                 # in place
    write_slot(cache_kr, slot, kr[:, 0])

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
    out = common.merge_heads(out[:, None]).to(x.dtype) @ p.wo
    return common.shard(out, common.BATCH, None, None)
