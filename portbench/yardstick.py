"""The benchmark's yardstick: counts, peaks and kernel names that later
changes to the program may not move.

* :data:`INSTRUCTIONS`, the unfolded instruction count of each of the
  eleven RVV-lite programs at ``paper_params`` (what the frozen copy of
  the trace layer in ``reference/rvvtrace`` builds);
* :func:`k1_bytes_bound`, the least bytes the engine scan (K1) has to
  move for one engine call over a grid, whatever the program folds;
* :func:`dense_lm_flops`, the model FLOPs of one training step of a dense
  decoder from its published widths;
* :data:`K1_KERNELS`, K1's CUDA kernels by name as the profiler reports
  them, and the H100's published peaks.
"""

from __future__ import annotations

import re

# Unfolded rows per program at paper size (chip_smoke's TRACE_T, which the
# reference's and the port's builds both reproduce).
INSTRUCTIONS = {
    "pathfinder": 1147, "jacobi2d": 247040, "somier": 1052674,
    "gemv": 100097, "dropout": 98304, "conv2d_7x7": 1000126,
    "densenet121_l105": 885537, "resnet50_l10": 9671553,
    "flashattention2": 2452400, "conv2d_batched": 45729, "mha": 253120,
}

# The least an engine row has to carry: three register ids (a byte
# each), one byte of flags (operand validity, vd read/write/no-fetch,
# load/store), one byte of base cost and a four-byte cacheline.
RECORD_BYTES = 9
# The engine's twelve int32 counters of one grid point.
COUNTER_BYTES = 12 * 4

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
BF16_DENSE_FLOPS = 989e12

# K1's kernels (csrc/engine_scan.cu): K1a and K1b with its scans; the
# exclusive scan's tag 0 is K1b's (K2 runs it under tag 1).
K1_KERNELS = re.compile(
    r"(engine_scan|engine_reg|l1_trace_sums|l1_bucket|scan_sums<0>"
    r"|scan_blocks<0>|scan_apply<0>|l1_walk|l1_reduce|l1_finish)"
    r"(<[^>]*>)?")


def k1_bytes_bound(rows: int, points: int) -> int:
    """Bytes one engine call must move at least: each simulated row's
    record read once and each grid point's counters written once.
    ``rows`` counts unfolded instructions, so the bound does not change
    with how the program folds."""
    return RECORD_BYTES * int(rows) + COUNTER_BYTES * int(points)


def attended_keys(seq_len: int, window: int | None) -> int:
    """Keys that all queries of one causal sequence attend, a window of
    ``window`` keys (the query's own included) if given."""
    if window is None or window >= seq_len:
        return seq_len * (seq_len + 1) // 2
    w = window
    return w * (w + 1) // 2 + (seq_len - w) * w


def dense_matmul_params(cfg: dict) -> int:
    """Parameters a token multiplies by in a dense SwiGLU decoder: the
    attention projections, the MLP and the output head (the embedding is
    a lookup)."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    hd = d // cfg["num_attention_heads"]
    q = cfg["num_attention_heads"] * hd
    kv = cfg["num_key_value_heads"] * hd
    attn = d * q + 2 * d * kv + q * d
    mlp = 3 * d * cfg["intermediate_size"]
    return L * (attn + mlp) + d * cfg["vocab_size"]


def dense_params(cfg: dict) -> int:
    """Every parameter: the matmul ones, the embedding and the norms."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    return (dense_matmul_params(cfg) + cfg["vocab_size"] * d
            + (2 * L + 1) * d)


def dense_lm_flops(cfg: dict, batch: int, seq_len: int) -> int:
    """Model FLOPs of one training step (forward and backward) over
    ``batch`` sequences of ``seq_len`` tokens: 6 per matmul parameter per
    token, and for attention 12 * d_head * heads per attended key per
    layer (QK^T and PV, 2 FLOPs a multiply-add, three passes).
    Recomputation is not counted."""
    tokens = batch * seq_len
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    hd = d // cfg["num_attention_heads"]
    width = cfg["num_attention_heads"] * hd
    keys = batch * attended_keys(seq_len, cfg.get("sliding_window"))
    return 6 * dense_matmul_params(cfg) * tokens + 12 * width * L * keys
