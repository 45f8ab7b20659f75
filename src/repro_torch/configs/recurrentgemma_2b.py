"""Assigned architecture config (see registry.py for fields)."""

from repro_torch.configs.registry import RECURRENTGEMMA_2B as CONFIG

CONFIG = CONFIG
