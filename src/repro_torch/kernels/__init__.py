"""Hand-written CUDA kernels for Hopper, each with a plain-torch twin.

``flash_attention`` (K5), ``dispersed_gemm`` (K3 grouped, K4 dispersed),
``rmsnorm`` (K6) and ``engine_scan`` (K1, the cycle engine), with ``ops``
(public wrappers), ``ref`` (oracles) and ``traffic`` (schedule byte
counts).
"""

from repro_torch.kernels import (dispersed_gemm, engine_scan, flash_attention,
                                 ops, ref, rmsnorm, traffic)

__all__ = ["dispersed_gemm", "engine_scan", "flash_attention", "ops", "ref",
           "rmsnorm", "traffic"]
