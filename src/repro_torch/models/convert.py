"""Carry the reference's LM weights and optimizer state into the port and
back.

``lm_params_from_jax(model, tree)`` loads the tree that the reference's
``TransformerLM.init(key)`` returns, as numpy arrays, into a port
``TransformerLM``: the same leaf names, the per-layer tensors sliced from
the reference's stacked ``layers`` leaves; ``lm_params_to_tree`` stacks
them back.  ``opt_state_from_jax``/``opt_state_to_tree`` do the same for
``training.optim``'s ``master``/``m``/``v``/``step``.  The trees are what
``checkpoint.manager`` writes in the reference's layout, so a training
checkpoint of either package resumes in the other.  Numpy and tensors
only: the port never imports jax or ``ml_dtypes``.
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


def _flatten(tree, prefix=()) -> dict[tuple[str, ...], object]:
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for key, sub in tree.items():
        out.update(_flatten(sub, prefix + (key,)))
    return out


def _ref_key(name: str) -> tuple[tuple[str, ...], int | None]:
    """(the reference tree's key path, the layer index or None) of a module
    parameter name: ``layers.<l>.attn.wq`` ← ``layers/attn/wq[l]``."""
    parts = tuple(name.split("."))
    if parts[0] == "layers":
        return ("layers",) + parts[2:], int(parts[1])
    return parts, None


def _as_tensor(leaf) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else tensor_from_numpy(np.asarray(leaf))


def _from_tree(model: TransformerLM, tree: dict) -> dict[str, torch.Tensor]:
    """The reference tree's leaves (numpy arrays or tensors) cut into one
    tensor a module parameter, by name; raises on a missing, extra or
    misshapen leaf."""
    flat = {key: _as_tensor(leaf) for key, leaf in _flatten(tree).items()}
    used, out = set(), {}
    for name, param in model.named_parameters():
        key, index = _ref_key(name)
        if key not in flat:
            raise KeyError(f"reference tree has no leaf {'/'.join(key)} for {name}")
        leaf = flat[key]
        if index is not None:
            if leaf.shape[0] != model.cfg.n_layers:
                raise ValueError(f"{'/'.join(key)}: {leaf.shape[0]} stacked layers, "
                                 f"model has {model.cfg.n_layers}")
            leaf = leaf[index]
        if tuple(leaf.shape) != tuple(param.shape):
            raise ValueError(f"{name}: reference shape {tuple(leaf.shape)} != "
                             f"{tuple(param.shape)}")
        out[name] = leaf
        used.add(key)
    extra = set(flat) - used
    if extra:
        raise ValueError(f"reference leaves the model does not have: "
                         f"{sorted('/'.join(k) for k in extra)}")
    return out


def to_tree(tensors: dict[str, torch.Tensor]) -> dict:
    """Tensors keyed by module parameter name as the reference's tree (new
    tensors, not views): each per-layer family stacked in layer order into
    one ``(L, ...)`` leaf."""
    tree: dict = {}
    stacks: dict[tuple[str, ...], dict[int, torch.Tensor]] = {}
    for name, t in tensors.items():
        key, index = _ref_key(name)
        if index is None:
            _put(tree, key, t.detach().clone())
        else:
            stacks.setdefault(key, {})[index] = t.detach()
    for key, layers in stacks.items():
        _put(tree, key, torch.stack([layers[i] for i in range(len(layers))]))
    return tree


def _put(tree: dict, key: tuple[str, ...], leaf) -> None:
    for part in key[:-1]:
        tree = tree.setdefault(part, {})
    tree[key[-1]] = leaf


def lm_params_from_jax(model: TransformerLM, tree: dict) -> TransformerLM:
    """Replace every parameter of ``model`` by the reference tree's leaf of
    the same name (numpy arrays, or tensors as ``checkpoint.manager.restore``
    gives them; on the model's device, in the leaf's own dtype: an fp32
    tree gives an fp32 model).  Raises on a missing, extra or misshapen
    leaf.  Returns ``model``."""
    leaves = _from_tree(model, tree)
    for name, param in model.named_parameters():
        param.data = leaves[name].to(param.device, copy=True)
    return model


def lm_params_to_tree(model: TransformerLM) -> dict:
    """The inverse of ``lm_params_from_jax``: the reference's param tree of
    ``model``'s weights (copies, on the model's device, in their dtypes),
    the per-layer ones stacked into the ``layers/...`` leaves as
    ``(L, ...)``."""
    return to_tree(dict(model.named_parameters()))


def opt_state_from_jax(model: TransformerLM, tree: dict) -> dict:
    """The reference's ``optim.init_state`` tree (``master``/``m``/``v``
    param trees and ``step``) as the port's ``training.optim`` state, keyed
    by ``model``'s parameter names, on the model's device."""
    dev = model.device
    out = {key: {name: leaf.to(dev, dtype=torch.float32, copy=True)
                 for name, leaf in _from_tree(model, tree[key]).items()}
           for key in ("master", "m", "v")}
    out["step"] = _as_tensor(tree["step"]).to(dev, dtype=torch.int32).reshape(())
    return out


def opt_state_to_tree(state: dict) -> dict:
    """The port's optimizer state as the reference's tree (the inverse of
    ``opt_state_from_jax``), the moments stacked as the params are."""
    return {**{key: to_tree(state[key]) for key in ("master", "m", "v")},
            "step": state["step"].detach()}
