"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``.

Each assigned architecture lives in its own module exposing ``CONFIG``
(exact published dimensions, see the per-file source citations) and
``smoke()`` (a reduced same-family variant for CPU tests).  Copies of
``repro.configs``: the same ``ArchConfig`` values, built from the port's
own ``repro_torch.models.common``.
"""

from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = [
    "granite_moe_1b_a400m",
    "olmoe_1b_7b",
    "xlstm_350m",
    "qwen3_0_6b",
    "deepseek_67b",
    "yi_6b",
    "h2o_danube_3_4b",
    "zamba2_7b",
    "qwen2_vl_72b",
    "whisper_medium",
]

ALIASES = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "xlstm-350m": "xlstm_350m",
    "qwen3-0.6b": "qwen3_0_6b",
    "deepseek-67b": "deepseek_67b",
    "yi-6b": "yi_6b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "zamba2-7b": "zamba2_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "whisper-medium": "whisper_medium",
}


def canonical(name: str) -> str:
    return ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get_config(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def get_smoke_config(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.smoke()


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}


def override(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
