"""Trace-from-model bridge: registry models -> certified foldable sweeps
(the port of the reference's ``bridge`` package).

Pipeline (one module per stage, see docs/bridge.md for the contract):

- :mod:`repro_torch.bridge.shapes` — walk a registry model, read every
  layer's concrete shapes from the port's block modules built on the
  ``meta`` device (no parameter memory), emit :class:`LayerOp` records
  (gemm / attn / scan) with network-level counts.
- :mod:`repro_torch.bridge.lower` — lower each op kind to a fixed-shape
  tile program built from ``Assembler.repeat`` deep nests with
  way-span-padded planes, so the outer loops certify exact under
  :mod:`repro_torch.core.folding`.
- :mod:`repro_torch.bridge.network` — deduplicate by shape signature,
  register one benchmark per unique signature (``net:*`` names, domain
  ``"network"``), and report per-model totals from per-kernel sweeps.

Front door: ``Sweep(network=("granite-8b", ...))`` in
:mod:`repro_torch.api`.  Nothing here runs at import time: lowering
registers ``net:*`` kernels only when a network is asked for.
"""

from repro_torch.bridge.shapes import TOKEN_BLOCK, LayerOp, model_ops
from repro_torch.bridge.lower import (ATTN_TILE, K_CAP, MT, N_CAP,
                                      SCAN_STEPS, SCAN_WIDTH_CAP, TILES,
                                      build_attn, build_gemm, build_scan,
                                      tile_for)
from repro_torch.bridge.network import (LoweredNetwork, NetworkUnit,
                                        lower_network, network_report)

__all__ = [
    "TOKEN_BLOCK", "LayerOp", "model_ops",
    "ATTN_TILE", "K_CAP", "MT", "N_CAP", "SCAN_STEPS", "SCAN_WIDTH_CAP",
    "TILES", "build_attn", "build_gemm", "build_scan", "tile_for",
    "LoweredNetwork", "NetworkUnit", "lower_network", "network_report",
]
