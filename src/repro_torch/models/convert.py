"""Carry the reference's LM weights and optimizer state into the port and
back.

``lm_params_from_jax(model, tree)`` loads the tree that the reference's
``init(key)`` returns, as numpy arrays, into a port ``TransformerLM``,
``XLSTMModel``, ``ZambaModel`` or ``EncDecModel``: the same leaf names,
each index in a module parameter's name (``layers.<l>``;
``enc_layers.<l>``, ``dec_layers.<l>``; ``macros.<i>.mlstm.<j>``,
``macros.<i>.mamba.<j>``) indexing the next stacked axis of the
reference's leaf, and a name without one (Zamba2's ``shared.attn.wq``,
Whisper's ``enc_norm`` and ``frontend_proj``) its unstacked leaf;
``lm_params_to_tree`` stacks them back, and ``param_shapes`` gives the
stacked tree's shapes (meta tensors) for the partition specs.
``opt_state_from_jax``/``opt_state_to_tree`` do the same for
``training.optim``'s ``master``/``m``/``v``/``step``.  The trees are what
``checkpoint.manager`` writes in the reference's layout, so a training
checkpoint of either package resumes in the other.  ``cache_from_jax``/
``cache_to_tree`` carry a recurrent or encoder-decoder model's nested cache
tree (tuples and dicts: Zamba2's ``attn_kv``, Whisper's ``self`` and
``cross``) across.
Numpy and tensors only: the port never imports jax or ``ml_dtypes``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


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


def _ref_key(name: str) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """(the reference tree's key path, the indices into its stacked axes) of
    a module parameter name: ``layers.<l>.attn.wq`` ←
    ``layers/attn/wq[l]``, ``macros.<i>.mlstm.<j>.wq`` ←
    ``macros/mlstm/wq[i, j]``, ``macros.<i>.mlstm_ln.<j>`` ←
    ``macros/mlstm_ln[i, j]``."""
    parts = name.split(".")
    return (tuple(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


def _as_tensor(leaf) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else tensor_from_numpy(np.asarray(leaf))


def _stack_counts(names) -> dict[tuple[str, ...], tuple[int, ...]]:
    """Per reference key, the sizes of its stacked axes (one more than the
    largest index at each)."""
    counts: dict[tuple[str, ...], tuple[int, ...]] = {}
    for name in names:
        key, index = _ref_key(name)
        prev = counts.get(key, (0,) * len(index))
        counts[key] = tuple(max(a, i + 1) for a, i in zip(prev, index))
    return counts


def _from_tree(model: nn.Module, tree: dict) -> dict[str, torch.Tensor]:
    """The reference tree's leaves (numpy arrays or tensors) cut into one
    tensor a module parameter, by name; raises on a missing, extra or
    misshapen leaf."""
    flat = {key: _as_tensor(leaf) for key, leaf in _flatten(tree).items()}
    counts = _stack_counts(n for n, _ in model.named_parameters())
    used, out = set(), {}
    for name, param in model.named_parameters():
        key, index = _ref_key(name)
        if key not in flat:
            raise KeyError(f"reference tree has no leaf {'/'.join(key)} for {name}")
        leaf = flat[key]
        if index:
            if tuple(leaf.shape[:len(index)]) != counts[key]:
                raise ValueError(f"{'/'.join(key)}: stacked {tuple(leaf.shape[:len(index)])}, "
                                 f"model has {counts[key]}")
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
    tensors, not views): each per-layer family stacked in index order into
    one leaf, ``(L, ...)`` or, doubly indexed, ``(n_macro, m_per_macro,
    ...)``."""
    tree: dict = {}
    stacks: dict[tuple[str, ...], dict[tuple[int, ...], torch.Tensor]] = {}
    for name, t in tensors.items():
        key, index = _ref_key(name)
        if not index:
            _put(tree, key, t.detach().clone())
        else:
            stacks.setdefault(key, {})[index] = t.detach()
    counts = _stack_counts(tensors)
    for key, parts in stacks.items():
        leaf = torch.stack([parts[i] for i in sorted(parts)])
        _put(tree, key, leaf.reshape(counts[key] + tuple(leaf.shape[1:])))
    return tree


def _put(tree: dict, key: tuple[str, ...], leaf) -> None:
    for part in key[:-1]:
        tree = tree.setdefault(part, {})
    tree[key[-1]] = leaf


def param_shapes(model: nn.Module) -> dict:
    """The reference's param tree of ``model`` as meta tensors (shape and
    dtype, no storage; ``jax.eval_shape(model.init, key)``'s counterpart),
    each per-layer family stacked as ``lm_params_to_tree`` stacks it: the
    tree ``distribution.partition.param_specs`` reads."""
    named = dict(model.named_parameters())
    counts = _stack_counts(named)
    tree: dict = {}
    for name, p in named.items():
        key, _ = _ref_key(name)
        _put(tree, key, torch.empty(counts[key] + tuple(p.shape), dtype=p.dtype, device="meta"))
    return tree


def lm_params_from_jax(model: nn.Module, tree: dict) -> nn.Module:
    """Replace every parameter of ``model`` by the reference tree's leaf of
    the same name (numpy arrays, or tensors as ``checkpoint.manager.restore``
    gives them; on the model's device, in the leaf's own dtype: an fp32
    tree gives an fp32 model).  Raises on a missing, extra or misshapen
    leaf.  Returns ``model``."""
    leaves = _from_tree(model, tree)
    for name, param in model.named_parameters():
        param.data = leaves[name].to(param.device, copy=True)
    return model


def lm_params_to_tree(model: nn.Module) -> dict:
    """The inverse of ``lm_params_from_jax``: the reference's param tree of
    ``model``'s weights (copies, on the model's device, in their dtypes),
    the per-layer ones stacked into the reference's leaves."""
    return to_tree(dict(model.named_parameters()))


def opt_state_from_jax(model: nn.Module, tree: dict) -> dict:
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


def flatten_by_layout(layout, tree) -> dict:
    """The leaves of a nested tree (dicts and tuples) keyed by the names
    that ``layout``, a tree of the same structure with string leaves (a
    model's ``CACHE_TREE``), puts in their places."""
    out: dict = {}

    def walk(lay, node):
        if isinstance(lay, str):
            out[lay] = node
        elif isinstance(lay, dict):
            for key in lay:
                walk(lay[key], node[key])
        else:
            assert len(lay) == len(node), (lay, len(node))
            for sub, leaf in zip(lay, node):
                walk(sub, leaf)

    walk(layout, tree)
    return out


def cache_from_jax(model: nn.Module, tree) -> dict[str, torch.Tensor]:
    """A recurrent or encoder-decoder model's cache from the reference's
    nested cache tree (dicts and tuples of numpy arrays or tensors), by the
    model's ``CACHE_TREE``: a flat dict of tensors on the model's device,
    each in its leaf's dtype."""
    return {key: _as_tensor(leaf).to(model.device, copy=True)
            for key, leaf in flatten_by_layout(model.CACHE_TREE, tree).items()}


def cache_to_tree(model: nn.Module, cache: dict[str, torch.Tensor]):
    """The inverse of ``cache_from_jax``: the reference's nested cache tree
    (dicts and tuples) of copies of ``cache``'s leaves."""
    def build(layout):
        if isinstance(layout, str):
            return cache[layout].detach().clone()
        if isinstance(layout, dict):
            return {key: build(sub) for key, sub in layout.items()}
        return tuple(build(sub) for sub in layout)

    return build(model.CACHE_TREE)
