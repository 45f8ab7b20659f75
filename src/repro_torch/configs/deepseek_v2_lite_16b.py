"""Assigned architecture config (see registry.py for fields)."""

from repro_torch.configs.registry import DEEPSEEK_V2_LITE as CONFIG

CONFIG = CONFIG
