"""Architecture config schema for the assigned model zoo."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 => d_model // num_heads

    # attention features
    positional: str = "rope"          # rope | mrope | sinusoidal | none
    rope_theta: float = 1e4
    qk_norm: bool = False
    attn_bias: bool = False
    sliding_window: Optional[int] = None
    attn_impl: str = "sdpa"           # sdpa (plain torch) | flash (CUDA kernel)

    # MLA (DeepSeek-V2)
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    moe: bool = False
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0       # leading dense layers (DeepSeek)

    # SSM (Mamba-1)
    ssm: bool = False
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2

    # hybrid (RecurrentGemma): layer i is attention iff (i % 3 == 2)
    hybrid: bool = False
    lru_width: Optional[int] = None

    # encoder-decoder (Whisper)
    encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 1500           # whisper 30s of mel frames

    # modality frontend stub ("input_specs provides precomputed embeddings")
    frontend: Optional[str] = None    # audio | vision

    mlp_kind: str = "swiglu"          # swiglu | gelu
    norm_kind: str = "rms"            # rms | layernorm
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    subquadratic: bool = False        # may run the long_500k shape

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        r = dict(
            num_layers=3 if self.hybrid else 2,
            d_model=128, num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 1,
            head_dim=32, d_ff=256, vocab_size=512,
        )
        if self.encoder_decoder:
            r["num_encoder_layers"] = 2
            r["encoder_seq"] = 16
        if self.mla:
            r.update(kv_lora_rank=32, qk_nope_dim=32, qk_rope_dim=16,
                     v_head_dim=32)
        if self.moe:
            r.update(num_experts=4, moe_top_k=2, moe_d_ff=64,
                     first_dense_layers=min(self.first_dense_layers, 1))
        if self.ssm:
            r.update(ssm_state=8, ssm_expand=2)
        if self.lru_width:
            r["lru_width"] = 128
        if self.sliding_window:
            r["sliding_window"] = 8
        return dataclasses.replace(self, **r)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks)."""
        d, l = self.d_model, self.num_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.ssm:
            din = self.ssm_expand * d
            n = self.ssm_state
            dtr = max(d // 16, 1)
            blk = (d * 2 * din + self.ssm_conv * din
                   + din * (dtr + 2 * n) + dtr * din + din * n + din * d)
            return emb + l * blk
        if self.mla:
            h = self.num_heads
            attn = (d * h * (self.qk_nope_dim + self.qk_rope_dim)
                    + d * self.kv_lora_rank + d * self.qk_rope_dim
                    + self.kv_lora_rank * h * (self.qk_nope_dim
                                               + self.v_head_dim)
                    + h * self.v_head_dim * d)
        else:
            hd = self.head_dim
            attn = d * hd * (self.num_heads * 2
                             + self.num_kv_heads * 2)
        ff_mult = 3 if self.mlp_kind == "swiglu" else 2
        dense_ff = ff_mult * d * self.d_ff
        if self.moe:
            moe_ff = (self.num_experts * 3 * d * self.moe_d_ff
                      + self.num_shared_experts * 3 * d * self.moe_d_ff
                      + d * self.num_experts)
            n_moe = l - self.first_dense_layers
            ff_total = self.first_dense_layers * dense_ff + n_moe * moe_ff
        else:
            ff_total = l * dense_ff
        if self.hybrid:
            w = self.lru_width or d
            n_att = l // 3
            n_rec = l - n_att
            rec = d * 2 * w + 4 * w + 2 * w * w + w * d
            return emb + n_att * (attn + dense_ff) + n_rec * (rec + dense_ff)
        layers = l * attn + ff_total
        if self.encoder_decoder:
            layers += self.num_encoder_layers * (attn + dense_ff) + l * attn
        return emb + layers

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k + shared only)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        inactive = ((self.num_experts - self.moe_top_k) * 3
                    * self.d_model * self.moe_d_ff
                    * (self.num_layers - self.first_dense_layers))
        return full - inactive
