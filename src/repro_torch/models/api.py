"""Model factory: ``build_model(cfg)`` dispatches on family.

Counterpart of ``repro.models.api``.  The port builds the ``dense``,
``moe`` and ``vlm`` families (``TransformerLM``); the ``ssm``, ``hybrid``
and ``audio`` families raise ``NotImplementedError`` naming the
``ROADMAP.md`` item that ports them, never a model of another family in
their place.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ArchConfig, device: str | torch.device | None = None,
                seed: int = 0) -> TransformerLM:
    """The model of ``cfg`` on ``device`` (``None`` → ``cuda``), its bf16
    weights (the MoE router's fp32) drawn from a generator seeded with
    ``seed``.  The dense, moe and vlm families are ported:
    ``TransformerLM`` raises for every other."""
    return TransformerLM(cfg, device=device, seed=seed)
