"""Assigned architecture config (see registry.py for fields)."""

from repro_torch.configs.registry import QWEN2_VL_7B as CONFIG

CONFIG = CONFIG
