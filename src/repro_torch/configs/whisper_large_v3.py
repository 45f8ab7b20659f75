"""Assigned architecture config (see registry.py for fields)."""

from repro_torch.configs.registry import WHISPER_LARGE_V3 as CONFIG

CONFIG = CONFIG
