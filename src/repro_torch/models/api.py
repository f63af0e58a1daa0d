"""Model factory: ``build_model(cfg)`` dispatches on family.

Counterpart of ``repro.models.api``.  The port builds every family of the
reference: the ``audio`` family (``EncDecModel``, whose config says
``enc_dec``), the ``ssm`` family (``XLSTMModel``), the ``hybrid`` family
(``ZambaModel``) and the ``dense``, ``moe`` and ``vlm`` families
(``TransformerLM``).
"""

from __future__ import annotations

import torch

from repro_torch.models.common import ArchConfig
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.recurrent import XLSTMModel, ZambaModel
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ArchConfig, device: str | torch.device | None = None,
                seed: int = 0) -> TransformerLM | XLSTMModel | ZambaModel | EncDecModel:
    """The model of ``cfg`` on ``device`` (``None`` → ``cuda``), its bf16
    weights (the MoE router's, the xLSTM gates' and Mamba2's ``a_log``,
    ``d_skip`` and ``dt_bias`` fp32) drawn from a generator seeded with
    ``seed``; on ``device="meta"`` shapes and dtypes only, no storage and no
    draws (the dry run's build).  ``TransformerLM`` raises for a family it
    does not build."""
    if cfg.enc_dec:
        return EncDecModel(cfg, device=device, seed=seed)
    if cfg.family == "ssm" and cfg.xlstm is not None:
        return XLSTMModel(cfg, device=device, seed=seed)
    if cfg.family == "hybrid" and cfg.ssm is not None:
        return ZambaModel(cfg, device=device, seed=seed)
    return TransformerLM(cfg, device=device, seed=seed)
