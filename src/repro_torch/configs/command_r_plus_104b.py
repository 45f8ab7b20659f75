"""Assigned architecture config (see registry.py for fields)."""

from repro_torch.configs.registry import COMMAND_R_PLUS as CONFIG

CONFIG = CONFIG
