"""Input specs per (architecture × shape): meta tensors as stand-ins (shape
and dtype, no storage) and real random batches for smoke tests.

Counterpart of ``repro.launch.specs``; meta tensors take the place of
``jax.ShapeDtypeStruct``.  ``make_batch`` draws from numpy as the reference
does, so its int32 leaves are the reference's bytes; its bf16 leaves
(``vis_embeds``, ``frames``) are float64 draws rounded as the reference
rounds them, through fp32 (``torch``'s conversion from float64 and
``jnp.asarray(..., bfloat16)`` give the same bits).  ``batch_logical``
gives the batch's logical axes, keyed as the batch, for
``distribution.partition.resolve_spec_tree``.

Layouts:
  decoder-only train : tokens (B,S) + labels (B,S)
  vlm                : vis_embeds (B,S/4,fd) + tokens (B,3S/4) + pos3 (3,B,S)
  audio (enc-dec)    : frames (B,S,fd) + tokens/labels (B,S/8)
  decode             : tokens (B,1) + pos () against a (B, S)-sized cache
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distribution.partition import Axes
from repro_torch.models.common import ArchConfig, ShapeSpec

I32 = torch.int32
BF16 = torch.bfloat16


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def vlm_split(s: int) -> tuple[int, int]:
    s_vis = s // 4
    return s_vis, s - s_vis


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict[str, torch.Tensor]:
    """The batch's leaves as meta tensors, in the reference's key order."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        batch = {}
        if cfg.family == "vlm":
            s_vis, s_text = vlm_split(s)
            batch["vis_embeds"] = _meta((b, s_vis, cfg.frontend_dim), BF16)
            batch["tokens"] = _meta((b, s_text), I32)
            batch["pos3"] = _meta((3, b, s), I32)
            if shape.kind == "train":
                batch["labels"] = _meta((b, s_text), I32)
        elif cfg.enc_dec:
            s_dec = max(1, s // 8)
            batch["frames"] = _meta((b, s, cfg.frontend_dim), BF16)
            if shape.kind == "train":
                batch["tokens"] = _meta((b, s_dec), I32)
                batch["labels"] = _meta((b, s_dec), I32)
        else:
            batch["tokens"] = _meta((b, s), I32)
            if shape.kind == "train":
                batch["labels"] = _meta((b, s), I32)
        return batch
    # decode: one new token against an s-long cache
    batch = {"tokens": _meta((b, 1), I32), "pos": _meta((), I32)}
    if cfg.family == "vlm":
        batch["pos3"] = _meta((3, b, 1), I32)
    return batch


def batch_logical(cfg: ArchConfig, shape: ShapeSpec) -> dict[str, Axes]:
    """Logical-axis tree matching ``input_specs`` (for resolve_spec_tree)."""
    out = {}
    for k, spec in input_specs(cfg, shape).items():
        if k == "pos":
            out[k] = Axes()
        elif k == "pos3":
            out[k] = Axes(None, "dp", None)
        elif spec.ndim == 3:  # vis_embeds / frames
            out[k] = Axes("dp", None, None)
        else:  # tokens / labels
            out[k] = Axes(*(["dp"] + [None] * (spec.ndim - 1)))
    return out


def make_batch(cfg: ArchConfig, shape: ShapeSpec, seed: int = 0,
               device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
    """Concrete random batch matching ``input_specs``, on ``device``
    (``None`` → ``cuda``), from ``numpy.random.default_rng(seed)``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, spec in input_specs(cfg, shape).items():
        if spec.dtype == I32:
            hi = cfg.vocab if k in ("tokens", "labels") else max(shape.seq_len, 2)
            arr = rng.integers(0, hi, size=tuple(spec.shape) or ())
            out[k] = torch.as_tensor(np.asarray(arr, np.int32), device=dev)
        else:
            # rounded on the host, where torch rounds as the reference
            out[k] = torch.from_numpy(rng.normal(0, 1, tuple(spec.shape))).to(BF16).to(dev)
    if "pos" in out:
        out["pos"] = torch.tensor(min(shape.seq_len - 1, 7), dtype=I32, device=dev)
    return out
