"""Model factory: ``build_model(cfg)`` dispatches on family.

Counterpart of ``repro.models.api``.  The port builds the ``dense`` family
(``TransformerLM``); every other family raises ``NotImplementedError``
naming the ``ROADMAP.md`` item that ports it, never a model of another
family in its place.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ArchConfig, device: str | torch.device | None = None) -> TransformerLM:
    """The model of ``cfg`` on ``device`` (``None`` → ``cuda``), its bf16
    weights drawn from a seeded generator.  Only the dense family is
    ported: ``TransformerLM`` raises for every other."""
    return TransformerLM(cfg, device=device)
