"""Analytic model FLOPs per (arch x shape) — the roofline's MODEL_FLOPS.

MODEL_FLOPS = 6 * N * D for dense training (2ND forward + 4ND backward),
6 * N_active * D for MoE, plus the attention quadratic term
(12 * B * H * S^2 * hd per layer trained; 4 * B * H * S * hd per decoded
token).  Inference (prefill/decode) uses the 2x forward-only factors.
The ratio MODEL_FLOPS / HLO_FLOPS flags remat/redundancy waste.

The port's copy of the reference's closed forms, unchanged but for the
device constants, which are NVIDIA H100 SXM's (the data sheet's dense
rates at the full 700 W limit, as ``PERF.md`` uses them).  The "HLO"
counts a roofline row reads are ``launch.hlo_cost``'s per-device
counts of the eager step.
"""

from __future__ import annotations

from repro_torch.configs import ShapeConfig
from repro_torch.configs.base import ArchConfig


def _attn_layers(cfg: ArchConfig) -> int:
    if cfg.ssm:
        return 0
    if cfg.hybrid:
        return sum(1 for i in range(cfg.num_layers) if i % 3 == 2)
    n = cfg.num_layers
    if cfg.encoder_decoder:
        n += cfg.num_encoder_layers + cfg.num_layers   # self + cross
    return n


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Returns dict(model_flops, matmul_param_flops, attn_flops, tokens)."""
    b = shape.global_batch
    train = shape.kind == "train"
    n_active = cfg.active_param_count()

    if shape.kind == "decode":
        tokens = b                       # one new token per sequence
        ctx = shape.seq_len
        fwd_factor = 2.0
        # attention reads the whole KV context per token
        hd = cfg.head_dim
        la = _attn_layers(cfg)
        if cfg.sliding_window:
            ctx = min(ctx, cfg.sliding_window)
        attn = 4.0 * b * cfg.num_heads * ctx * hd * la
    else:
        tokens = b * shape.seq_len
        fwd_factor = 6.0 if train else 2.0
        hd = cfg.head_dim
        la = _attn_layers(cfg)
        s = shape.seq_len
        causal_frac = 0.5 if not cfg.encoder_decoder else 1.0
        if cfg.sliding_window:
            s_eff = min(s, cfg.sliding_window)
            quad = b * cfg.num_heads * s * s_eff * hd
        else:
            quad = b * cfg.num_heads * s * s * hd * causal_frac
        attn = (2.0 if not train else 6.0) * 2.0 * quad * la

    param_flops = fwd_factor * n_active * tokens
    return dict(model_flops=param_flops + attn,
                matmul_param_flops=param_flops, attn_flops=attn,
                tokens=tokens)


def analytic_hbm_bytes(cfg: ArchConfig, shape: ShapeConfig,
                       chips: int = 256, microbatches: int = 1) -> float:
    """Minimum-HBM-traffic estimate per chip per step (documented formulas;
    the op-level loop-corrected HLO bytes are an upper bound because they
    count every intermediate at every op — VMEM/register-resident values
    included).  Components:

    train:  3x param reads (fwd + remat recompute + bwd) x microbatches
            + grad write/read (f32) + AdamW state R/W (3 x f32 R + 2 x W)
            + 2x layer-boundary activation R/W
            + logits write/read (f32)
    decode: 1x param read + KV/state cache read + write of one token slot
    prefill: 1x param read + 2x activation R/W + KV write
    """
    p_total = cfg.param_count() * 2.0            # bf16
    p_dev = p_total / chips
    d = cfg.d_model
    b = shape.global_batch
    if shape.kind == "decode":
        ctx = shape.seq_len
        if cfg.sliding_window:
            ctx = min(ctx, cfg.sliding_window)
        if cfg.ssm:
            cache = (cfg.num_layers * b * cfg.ssm_expand * d
                     * (cfg.ssm_state * 4 + 2.0))
        elif cfg.mla:
            cache = (cfg.num_layers * b * ctx
                     * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2.0)
        else:
            la = _attn_layers(cfg)
            cache = (2 * la * b * ctx * cfg.num_kv_heads
                     * cfg.head_dim * 2.0)
        return (p_total + cache) / chips
    tokens = b * shape.seq_len
    act = tokens * d * 2.0 * cfg.num_layers      # boundary activations
    logits = tokens * cfg.vocab_size * 4.0
    if shape.kind == "prefill":
        return (p_total + 2 * act + logits) / chips
    n_params = cfg.param_count()
    opt = n_params * (3 * 4.0 + 2 * 4.0)         # m,v,master R + m,v W
    grads = n_params * 2 * 4.0
    return (3 * p_total * microbatches + grads + opt + 4 * act
            + 2 * logits) / chips


# NVIDIA H100 SXM (data sheet; dense, no sparsity, 700 W).
H100_PEAK_FLOPS = 989e12     # bf16 tensor-core FLOP/s per card
H100_HBM_BW = 3.35e12        # HBM3 bytes/s per card
H100_NVLINK_BW = 450e9       # NVLink bytes/s per card, per direction


def roofline_terms(cell: dict, cfg: ArchConfig, shape: ShapeConfig,
                   chips: int = 256) -> dict:
    """Three roofline terms (seconds) from one dry-run cell record.

    The counted step is the per-device program (``launch.hlo_cost``
    counts each rank's local shards), so its FLOPs/bytes are already
    per card.
    """
    flops_dev = cell.get("dot_flops_loop_corrected") or 0.0
    bytes_dev_ub = cell.get("bytes_loop_corrected") or 0.0
    coll_dev = (cell.get("collectives") or {}).get("collective_bytes", 0.0)
    mf = model_flops(cfg, shape)
    mb = cell.get("microbatches", 1)
    bytes_dev = analytic_hbm_bytes(cfg, shape, chips, mb)
    t_compute = flops_dev / H100_PEAK_FLOPS
    t_memory = bytes_dev / H100_HBM_BW
    t_memory_ub = bytes_dev_ub / H100_HBM_BW
    t_coll = coll_dev / H100_NVLINK_BW
    dom = max((t_compute, "compute"), (t_memory, "memory"),
              (t_coll, "collective"))
    useful = mf["model_flops"] / max(flops_dev * chips, 1.0)
    # step-time bracket: perfect compute/comm/memory overlap (max of terms)
    # vs fully serialized (sum); achievable MFU = model flops against the
    # perfectly-overlapped bound.
    t_lb = max(t_compute, t_memory, t_coll)
    t_ub = t_compute + t_memory + t_coll
    mfu_ub = mf["model_flops"] / (chips * H100_PEAK_FLOPS
                                    * max(t_lb, 1e-12))
    return dict(t_compute=t_compute, t_memory=t_memory,
                t_memory_opbytes_ub=t_memory_ub, t_collective=t_coll,
                bottleneck=dom[1],
                model_flops=mf["model_flops"],
                hlo_flops_global=flops_dev * chips,
                useful_flop_ratio=useful,
                t_step_overlap=t_lb, t_step_serial=t_ub,
                mfu_upper_bound=mfu_ub,
                roofline_fraction=t_compute / max(t_lb, 1e-12))
