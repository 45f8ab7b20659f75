"""The device an entry point runs on, shared by every layer of the port."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point was asked for.  CUDA is the default of
    every entry point, and a request for it on a machine without a card
    raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev
