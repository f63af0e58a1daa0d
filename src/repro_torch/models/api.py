"""Model factory: ``build_model(cfg)`` dispatches on family.

Counterpart of ``repro.models.api``.  The port builds the ``dense``,
``moe`` and ``vlm`` families (``TransformerLM``), the ``ssm`` family
(``XLSTMModel``) and the ``hybrid`` family (``ZambaModel``); the ``audio``
family raises ``NotImplementedError`` naming the ``ROADMAP.md`` item that
ports it, never a model of another family in its place.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import ArchConfig
from repro_torch.models.recurrent import XLSTMModel, ZambaModel
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ArchConfig, device: str | torch.device | None = None,
                seed: int = 0) -> TransformerLM | XLSTMModel | ZambaModel:
    """The model of ``cfg`` on ``device`` (``None`` → ``cuda``), its bf16
    weights (the MoE router's, the xLSTM gates' and Mamba2's ``a_log``,
    ``d_skip`` and ``dt_bias`` fp32) drawn from a generator seeded with
    ``seed``.  The dense, moe, vlm, ssm and hybrid families are ported:
    ``TransformerLM`` raises for every other."""
    if cfg.family == "ssm" and cfg.xlstm is not None:
        return XLSTMModel(cfg, device=device, seed=seed)
    if cfg.family == "hybrid" and cfg.ssm is not None:
        return ZambaModel(cfg, device=device, seed=seed)
    return TransformerLM(cfg, device=device, seed=seed)
