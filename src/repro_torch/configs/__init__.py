"""Architecture registry of the port: ``get_config(name)`` / ``--arch <id>``.

Every architecture of the JAX package's registry is listed; asking for
any other name raises ``NotImplementedError``.
"""
from __future__ import annotations

import importlib

from .base import ArchConfig  # noqa: F401

ARCH_IDS = ["qwen3_0_6b", "xlstm_1_3b", "zamba2_2_7b", "qwen3_14b",
            "qwen2_1_5b", "moonshot_v1_16b_a3b", "mixtral_8x22b",
            "qwen2_vl_7b", "whisper_small", "nemotron_4_340b"]


def get_config(name: str) -> ArchConfig:
    """An id of ``ARCH_IDS`` (``qwen3_0_6b``) or its dashed form (``qwen3-0.6b``)."""
    mod_name = name.replace("-", "_").replace(".", "_")
    if mod_name not in ARCH_IDS:
        raise NotImplementedError(f"arch {name!r} is not in the registry")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
