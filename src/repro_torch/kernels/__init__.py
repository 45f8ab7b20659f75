"""Hand-written CUDA kernels for Hopper, each with a plain-torch twin.

``flash_attention`` (K5), ``dispersed_gemm`` (K3 grouped, K4 dispersed)
and ``rmsnorm`` (K6), with ``ops`` (public wrappers), ``ref`` (oracles)
and ``traffic`` (schedule byte counts).
"""

from repro_torch.kernels import (dispersed_gemm, flash_attention, ops, ref,
                                 rmsnorm, traffic)

__all__ = ["dispersed_gemm", "flash_attention", "ops", "ref", "rmsnorm",
           "traffic"]
