"""Config registry of the port: the architectures it runs (``--arch``).

Each ``repro_torch/configs/<id>.py`` exports ``CONFIG`` and ``SMOKE``.
Only ported architectures resolve; any other raises.
"""
from __future__ import annotations

import importlib

from .models.base import ArchConfig

# canonical ids of the ported architectures → module names
ARCH_IDS = {"rwkv6-1.6b": "rwkv6_1g6b"}


def normalize_arch(arch: str) -> str:
    """The config module name of ``arch`` (``rwkv6-1.6b`` or
    ``rwkv6_1g6b``)."""
    name = ARCH_IDS.get(arch, arch.replace("-", "_").replace(".", "g"))
    if name not in ARCH_IDS.values():
        raise NotImplementedError(
            f"architecture {arch!r} is not ported yet (ROADMAP Queue 1 "
            f"item 9); ported: {sorted(ARCH_IDS)}")
    return name


def get_config(arch: str, *, smoke: bool = False) -> ArchConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{normalize_arch(arch)}")
    return mod.SMOKE if smoke else mod.CONFIG
