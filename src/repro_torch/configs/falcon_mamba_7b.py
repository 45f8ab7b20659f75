"""Assigned architecture config (see registry.py for fields)."""

from repro_torch.configs.registry import FALCON_MAMBA_7B as CONFIG

CONFIG = CONFIG
