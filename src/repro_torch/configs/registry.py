"""The ten assigned architectures (exact configs from the assignment) plus
the shape grid.  ``get(name)`` / ``ARCHS`` are the public entry points."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig

ARCHS: dict[str, ArchConfig] = {}


def _reg(cfg: ArchConfig) -> ArchConfig:
    ARCHS[cfg.name] = cfg
    return cfg


# --- SSM -------------------------------------------------------------------
FALCON_MAMBA_7B = _reg(ArchConfig(
    name="falcon-mamba-7b", family="ssm", num_layers=64, d_model=4096,
    num_heads=1, num_kv_heads=1, d_ff=0, vocab_size=65024,
    positional="none", ssm=True, ssm_state=16, ssm_conv=4, ssm_expand=2,
    mlp_kind="swiglu", subquadratic=True))

# --- audio enc-dec ---------------------------------------------------------
WHISPER_LARGE_V3 = _reg(ArchConfig(
    name="whisper-large-v3", family="audio", num_layers=32, d_model=1280,
    num_heads=20, num_kv_heads=20, d_ff=5120, vocab_size=51866,
    positional="sinusoidal", attn_bias=True, encoder_decoder=True,
    num_encoder_layers=32, encoder_seq=1500, frontend="audio",
    mlp_kind="gelu", norm_kind="layernorm"))

# --- hybrid ----------------------------------------------------------------
RECURRENTGEMMA_2B = _reg(ArchConfig(
    name="recurrentgemma-2b", family="hybrid", num_layers=26, d_model=2560,
    num_heads=10, num_kv_heads=1, head_dim=256, d_ff=7680,
    vocab_size=256000, hybrid=True, lru_width=2560, sliding_window=2048,
    mlp_kind="gelu", tie_embeddings=True, subquadratic=True))

# --- VLM -------------------------------------------------------------------
QWEN2_VL_7B = _reg(ArchConfig(
    name="qwen2-vl-7b", family="vlm", num_layers=28, d_model=3584,
    num_heads=28, num_kv_heads=4, d_ff=18944, vocab_size=152064,
    positional="mrope", attn_bias=True, frontend="vision",
    rope_theta=1e6))

# --- dense -----------------------------------------------------------------
PHI3_MINI = _reg(ArchConfig(
    name="phi3-mini-3.8b", family="dense", num_layers=32, d_model=3072,
    num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=32064))

GRANITE_8B = _reg(ArchConfig(
    name="granite-8b", family="dense", num_layers=36, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=49152))

COMMAND_R_PLUS = _reg(ArchConfig(
    name="command-r-plus-104b", family="dense", num_layers=64,
    d_model=12288, num_heads=96, num_kv_heads=8, d_ff=33792,
    vocab_size=256000, rope_theta=75e4))

QWEN3_8B = _reg(ArchConfig(
    name="qwen3-8b", family="dense", num_layers=36, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=12288,
    vocab_size=151936, qk_norm=True, rope_theta=1e6))

# --- MoE -------------------------------------------------------------------
DEEPSEEK_V2_LITE = _reg(ArchConfig(
    name="deepseek-v2-lite-16b", family="moe", num_layers=27, d_model=2048,
    num_heads=16, num_kv_heads=16, d_ff=10944, vocab_size=102400,
    mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128, moe=True, num_experts=64, num_shared_experts=2,
    moe_top_k=6, moe_d_ff=1408, first_dense_layers=1))

PHI35_MOE = _reg(ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=6400, vocab_size=32064,
    moe=True, num_experts=16, moe_top_k=2, moe_d_ff=6400,
    norm_kind="layernorm"))


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


# ---------------------------------------------------------------------------
# Shape grid (assignment): every arch x every shape = one dry-run cell.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_runnable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable dry-run cell per assignment rules.

    ``long_500k`` needs sub-quadratic attention: run for SSM/hybrid, skip for
    pure full-attention archs (documented in DESIGN.md §4)."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, ("full-attention arch: 500k dense-KV decode is "
                       "quadratic-state; skipped per assignment rules")
    return True, ""
