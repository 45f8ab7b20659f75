"""Assigned architecture config (see registry.py for fields)."""

from repro_torch.configs.registry import PHI3_MINI as CONFIG

CONFIG = CONFIG
