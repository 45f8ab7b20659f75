"""Assigned architecture config (see registry.py for fields)."""

from repro_torch.configs.registry import GRANITE_8B as CONFIG

CONFIG = CONFIG
