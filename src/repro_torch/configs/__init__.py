"""Architecture + shape configs for the assigned model zoo."""

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import (ARCHS, SHAPES, ShapeConfig,
                                    cell_runnable, get)

__all__ = ["ArchConfig", "ARCHS", "SHAPES", "ShapeConfig",
           "cell_runnable", "get"]
