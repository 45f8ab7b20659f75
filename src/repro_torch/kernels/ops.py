"""Public wrappers for the package's kernels.

Each wrapper runs its kernel's plain twin for CPU tensors and launches the
CUDA kernel for CUDA tensors; there is no fallback between the two.
"""

from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None, block_q: int = 128,
                    block_k: int = 128):
    """FlashAttention-2 with GQA support: k/v may have fewer heads than q
    (q heads must be a multiple).  The kernel reads KV head h // (Hq/Hkv)
    in place, the mapping of the reference's head repeat."""
    hq, hkv = q.shape[1], k.shape[1]
    if hkv != hq and (hkv == 0 or hq % hkv):
        raise ValueError(
            f"GQA needs q heads ({hq}) to be a multiple of k/v heads "
            f"({hkv})")
    _fa._check_blocks(q.shape[2], k.shape[2], block_q=block_q,
                      block_k=block_k)
    return _fa._attend(q, k, v, causal=causal, scale=scale)
