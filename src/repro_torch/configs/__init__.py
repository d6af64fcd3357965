"""Architecture registry of the port: ``--arch <id>`` resolves here.

The JAX registry's ten architectures, in its order (``ARCH_IDS``), and the
architectures only the port runs (``PORT_ARCH_IDS``, configs of
``configs.port.PortArchConfig``).  Each module exports ``config()`` (exact
published shape) and ``reduced()`` (tiny same-family variant for CPU smoke
tests).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeCell, applicable_shapes

ARCH_IDS = [
    "deepseek_v3_671b",
    "grok_1_314b",
    "command_r_35b",
    "starcoder2_3b",
    "qwen3_8b",
    "gemma3_1b",
    "xlstm_125m",
    "whisper_large_v3",
    "internvl2_1b",
    "recurrentgemma_9b",
]

PORT_ARCH_IDS = [
    "command_a_plus_05_2026",
]

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS + PORT_ARCH_IDS}


def _module(arch: str):
    arch = _ALIASES.get(arch, arch)
    if arch not in ARCH_IDS + PORT_ARCH_IDS:
        known = ARCH_IDS + PORT_ARCH_IDS + list(_ALIASES)
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(known)}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ArchConfig:
    return _module(arch).config()


def get_reduced(arch: str) -> ArchConfig:
    return _module(arch).reduced()


def make_model(cfg: ArchConfig):
    """Instantiate the right model class for a config."""
    from repro_torch.models.encdec import EncDec
    from repro_torch.models.lm import LM

    return EncDec(cfg) if cfg.encdec is not None else LM(cfg)


__all__ = [
    "ARCH_IDS",
    "ArchConfig",
    "PORT_ARCH_IDS",
    "SHAPES",
    "ShapeCell",
    "applicable_shapes",
    "get_config",
    "get_reduced",
    "make_model",
]
