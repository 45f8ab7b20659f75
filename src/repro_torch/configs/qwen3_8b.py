"""Assigned architecture config (see registry.py for fields)."""

from repro_torch.configs.registry import QWEN3_8B as CONFIG

CONFIG = CONFIG
