"""Carry the reference's LM weights into the port.

``lm_params_from_jax(model, tree)`` loads the tree that the reference's
``TransformerLM.init(key)`` returns, as numpy arrays, into a port
``TransformerLM``: the same leaf names, the per-layer tensors sliced from
the reference's stacked ``layers`` leaves.  It takes numpy only, so the port
never imports jax or ``ml_dtypes``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import TransformerLM


def tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor holding a copy of ``arr`` in its dtype.  bf16 arrays
    (numpy arrays of ``ml_dtypes.bfloat16``, recognised by their dtype's
    name) are reinterpreted through their raw 16-bit words, so the bits
    carry over."""
    arr = np.array(arr)  # a writable, contiguous copy (jax hands out read-only views)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(tree, prefix=()) -> dict[tuple[str, ...], np.ndarray]:
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for key, sub in tree.items():
        out.update(_flatten(sub, prefix + (key,)))
    return out


def lm_params_from_jax(model: TransformerLM, tree: dict) -> TransformerLM:
    """Replace every parameter of ``model`` by the reference tree's leaf of
    the same name (on the model's device, in the leaf's own dtype: an fp32
    tree gives an fp32 model).  Raises on a missing, extra or misshapen
    leaf.  Returns ``model``."""
    flat = _flatten(tree)
    used = set()
    for name, param in model.named_parameters():
        parts = tuple(name.split("."))
        if parts[0] == "layers":  # layers.<l>.attn.wq ← layers/attn/wq[l]
            key, index = ("layers",) + parts[2:], int(parts[1])
        else:
            key, index = parts, None
        if key not in flat:
            raise KeyError(f"reference tree has no leaf {'/'.join(key)} for {name}")
        arr = np.asarray(flat[key])
        if index is not None:
            if arr.shape[0] != model.cfg.n_layers:
                raise ValueError(f"{'/'.join(key)}: {arr.shape[0]} stacked layers, "
                                 f"model has {model.cfg.n_layers}")
            arr = arr[index]
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{name}: reference shape {arr.shape} != {tuple(param.shape)}")
        param.data = tensor_from_numpy(arr).to(param.device)
        used.add(key)
    extra = set(flat) - used
    if extra:
        raise ValueError(f"reference leaves the model does not have: "
                         f"{sorted('/'.join(k) for k in extra)}")
    return model
