"""RVV-lite benchmark suite — the nine applications of the paper's Table 2
plus two beyond-paper deep-nest workloads (batched conv, multi-head
attention) exercising the per-level stride vectors of ``Assembler.repeat``.

Kernels self-register via :func:`common.register_benchmark`; importing this
package populates :data:`BENCHMARKS` (a registry whose unknown-name lookups
raise with the sorted list of available kernels).  The import order below
fixes the registry iteration order to the paper's Table 2 sequence, with the
beyond-paper workloads last.
"""

from __future__ import annotations

# Table 2 order first (it is the registry's iteration order), then the
# beyond-paper deep-nest workloads.  Each import registers its kernels.
from repro_torch.rvv import pathfinder     # noqa: F401  "pathfinder"
from repro_torch.rvv import jacobi2d       # noqa: F401  "jacobi2d"
from repro_torch.rvv import somier         # noqa: F401  "somier"
from repro_torch.rvv import gemv           # noqa: F401  "gemv"
from repro_torch.rvv import dropout       # noqa: F401  "dropout"
from repro_torch.rvv import conv2d         # noqa: F401  "conv2d_7x7"
from repro_torch.rvv import gemm           # noqa: F401  "densenet121_l105", "resnet50_l10"
from repro_torch.rvv import flashattention2  # noqa: F401  "flashattention2"
from repro_torch.rvv import conv2d_batched  # noqa: F401  "conv2d_batched"
from repro_torch.rvv import mha            # noqa: F401  "mha"

from repro_torch.rvv import common
from repro_torch.rvv.common import (BENCHMARKS, Benchmark, Built, check,
                              get_benchmark, register_benchmark)

# The paper's Table 3 reference numbers, for side-by-side reporting.
PAPER_TABLE3 = {
    "pathfinder": dict(speedup=7.99, active_regs=6, util=0.18),
    "jacobi2d": dict(speedup=6.48, active_regs=7, util=0.21),
    "somier": dict(speedup=7.82, active_regs=14, util=0.44),
    "gemv": dict(speedup=6.89, active_regs=9, util=0.28),
    "dropout": dict(speedup=4.3, active_regs=3, util=0.09),
    "conv2d_7x7": dict(speedup=7.74, active_regs=15, util=0.47),
    "densenet121_l105": dict(speedup=7.82, active_regs=4, util=0.12),
    "resnet50_l10": dict(speedup=7.63, active_regs=4, util=0.12),
    "flashattention2": dict(speedup=7.91, active_regs=32, util=1.00),
}

__all__ = ["BENCHMARKS", "PAPER_TABLE3", "Benchmark", "Built", "check",
           "common", "conv2d", "conv2d_batched", "dropout",
           "flashattention2", "gemm", "gemv", "get_benchmark", "jacobi2d",
           "mha", "pathfinder", "register_benchmark", "somier"]
