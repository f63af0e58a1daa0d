"""Model factory: ``build_model(cfg)`` dispatches on family.

Counterpart of ``repro.models.api``.  The port builds the ``dense``,
``moe`` and ``vlm`` families (``TransformerLM``) and the ``ssm`` family
(``XLSTMModel``); the ``hybrid`` and ``audio`` families raise
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports them,
never a model of another family in their place.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import ArchConfig
from repro_torch.models.recurrent import XLSTMModel
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ArchConfig, device: str | torch.device | None = None,
                seed: int = 0) -> TransformerLM | XLSTMModel:
    """The model of ``cfg`` on ``device`` (``None`` → ``cuda``), its bf16
    weights (the MoE router's and the xLSTM gates' fp32) drawn from a
    generator seeded with ``seed``.  The dense, moe, vlm and ssm families
    are ported: ``TransformerLM`` raises for every other."""
    if cfg.family == "ssm" and cfg.xlstm is not None:
        return XLSTMModel(cfg, device=device, seed=seed)
    return TransformerLM(cfg, device=device, seed=seed)
