"""Assigned architecture config (see registry.py for fields)."""

from repro_torch.configs.registry import PHI35_MOE as CONFIG

CONFIG = CONFIG
