"""Logical-axis partitioning.

Counterpart of ``repro.distribution.partition``.  Models name the axes of
their tensors with *logical* axes ("dp", "sp", "tp", "ep", None); a
launcher installs a rule set mapping logical → mesh axes, and these
functions resolve them into ``PartitionSpec``s against a mesh's axis
sizes, with the reference's rules: a "tp" that does not divide its dim
shifts right to the next free dim it divides, any other axis that does
not divide drops to replication.

The trees are the reference's: nested dicts (and tuples) whose leaves are
anything with a ``shape`` (tensors, meta tensors) or ``Axes``; parameter
trees are the reference's stacked layout, which
``models.convert.param_shapes`` gives for a port model;
``models.convert._ref_key`` takes each port parameter name
(``layers.3.attn.wq``) to its stacked leaf's path and index.

``shard(x, *logical)`` returns ``x``: in eager single-process torch a
sharding constraint changes no value, and the port's models call none.
"""

from __future__ import annotations

import re
from typing import Any, Callable


class PartitionSpec(tuple):
    """A tuple of mesh-axis entries, one per dim: a mesh axis name, a tuple
    of them, or None (replicated), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

_RULES: dict[str, Any] | None = None


def set_axis_rules(rules: dict[str, Any] | None) -> None:
    """rules e.g. {"dp": ("pod", "data"), "tp": "model", "sp": "model",
    "ep": "model"}.  None disables all constraints."""
    global _RULES
    _RULES = rules


def get_axis_rules() -> dict[str, Any] | None:
    return _RULES


def logical_to_spec(*logical: str | None) -> P:
    assert _RULES is not None
    return P(*[_RULES.get(a) if a is not None else None for a in logical])


def set_mesh_sizes(sizes: dict[str, int] | None) -> None:
    """Kept only to match the reference's API, where it installs the axis
    sizes its ``shard`` resolves against; the port's ``shard`` changes
    nothing, so the sizes are not kept."""


def shard(x, *logical: str | None):
    """The reference's sharding annotation: ``x`` itself (no value changes
    under a constraint; with one process there is nothing to place)."""
    return x


# --------------------------------------------------------------------- #
# Parameter partitioning rules
# --------------------------------------------------------------------- #
# (regex on the leaf path, rule) — first match wins.  The rule is a tuple of
# logical axes for the *trailing* dims of the leaf; leading stacked-layer
# dims are padded with None automatically.
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed$", (None, "tp")),  # (V, D): shard D
    (r"lm_head$", (None, "tp")),  # (D, V): shard V
    (r"pos_embed$", (None, None)),
    (r"frontend_proj$", (None, "tp")),
    (r"router$", (None, None)),
    # MoE expert banks (E, D, F) / (E, F, D): expert-parallel over tp
    (r"moe/w[123]$", ("ep", None, None)),
    # attention
    (r"w[qkv]$", (None, "tp")),
    (r"wo$", ("tp", None)),
    # dense mlp
    (r"mlp/w[13]$", (None, "tp")),
    (r"mlp/w2$", ("tp", None)),
    (r"w_ff1$", (None, "tp")),
    (r"w_ff2$", ("tp", None)),
    # mamba / mlstm projections
    (r"w[xz]$", (None, "tp")),
    (r"w[xz]_up$", (None, "tp")),
    (r"wbc$", (None, None)),
    (r"wdt$", (None, None)),
    (r"out_proj$", ("tp", None)),
    (r"down_proj$", ("tp", None)),
    (r"conv_x$", (None, "tp")),
    (r"conv_x_b$", ("tp",)),
    (r"conv_w$", (None, "tp")),
    (r"conv_b$", ("tp",)),
    # sLSTM recurrent (H, hd, 4hd): shard heads
    (r"/r$", ("tp", None, None)),
    (r"w_in$", (None, "tp")),
    # everything else (norm scales, biases, gates, a_log, ...): replicate
]


def _spec_for_leaf(path: str, shape, mesh_axis_sizes) -> P:
    for pat, rule in _PARAM_RULES:
        if re.search(pat, path):
            axes = [None] * (len(shape) - len(rule)) + list(rule)
            # drop shardings that do not divide the dim evenly
            resolved = []
            for dim, ax in zip(shape, axes):
                if ax is None:
                    resolved.append(None)
                    continue
                mesh_ax = _RULES.get(ax) if _RULES else None
                size = _axis_size(mesh_ax, mesh_axis_sizes)
                resolved.append(mesh_ax if size and dim % size == 0 else None)
            return P(*resolved)
    return P(*([None] * len(shape)))


def _axis_size(mesh_ax, sizes) -> int:
    if mesh_ax is None or sizes is None:
        return 0
    if isinstance(mesh_ax, tuple):
        n = 1
        for a in mesh_ax:
            n *= sizes[a]
        return n
    return sizes[mesh_ax]


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a mesh (anything with ``axis_names`` and
    ``devices.shape``)."""
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def resolve_spec(shape, logical, mesh) -> P:
    """Resolve logical axes against concrete dims: a sharding that does not
    divide its dim evenly is shifted right ("tp" only) or dropped.  Used for
    KV-cache / state trees where the natural shard target (kv-heads) may be
    smaller than the tensor-parallel degree."""
    assert _RULES is not None
    sizes = mesh_sizes(mesh)
    resolved = [None] * len(shape)
    for i, ax in enumerate(logical):
        if ax is None:
            continue
        mesh_ax = _RULES.get(ax)
        size = _axis_size(mesh_ax, sizes)
        if size and shape[i] % size == 0:
            resolved[i] = mesh_ax
        elif ax == "tp" and size:
            for j in range(i + 1, len(shape)):
                if logical[j] is None and resolved[j] is None and shape[j] % size == 0:
                    resolved[j] = mesh_ax
                    break
    return P(*resolved)


class Axes:
    """Leaf wrapper for logical-axis tuples (tuples are tree nodes)."""

    def __init__(self, *axes):
        self.axes = axes

    def __repr__(self):
        return f"Axes{self.axes}"


def tree_map(fn: Callable, tree, *rest, path=()):
    """``fn(path, leaf, *matching leaves)`` over nested dicts, tuples and
    lists (the port's trees; a ``PartitionSpec`` is a leaf); ``rest`` are
    trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), path=path + (str(k),))
                for k in tree}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        assert all(len(r) == len(tree) for r in rest), "tree structures differ"
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest), path=path + (str(i),))
                          for i, t in enumerate(tree))
    return fn(path, tree, *rest)


def resolve_spec_tree(shapes_tree, logical_tree, mesh):
    """Map ``resolve_spec`` over matching (shape, logical) trees; the logical
    tree mirrors the shapes tree with ``Axes(...)`` leaves."""
    return tree_map(lambda _, s, l: resolve_spec(tuple(s.shape), l.axes, mesh),
                    shapes_tree, logical_tree)


def zero_specs(pspecs_tree, params_tree, mesh):
    """ZeRO-style specs: extend each param spec by sharding the first
    unsharded, divisible dim over the data axes.  Used for optimizer state
    (ZeRO-1) and gradient reduce-scatter (ZeRO-2): a 67B model's fp32
    master+m+v would otherwise replicate 12 B/param across the data axis."""
    assert _RULES is not None
    dp_ax = _RULES.get("dp")
    dp_size = _axis_size(dp_ax, mesh_sizes(mesh))

    def leaf(_, spec, arr):
        shape = tuple(arr.shape)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        if dp_size <= 1:
            return P(*parts)
        dp_entry = dp_ax if isinstance(dp_ax, str) else tuple(dp_ax)
        dp_names = {dp_ax} if isinstance(dp_ax, str) else set(dp_ax)

        def axes_of(p):
            if p is None:
                return set()
            return set(p) if isinstance(p, tuple) else {p}

        if any(axes_of(p) & dp_names for p in parts):  # idempotent
            return P(*parts)
        for i, (dim, cur) in enumerate(zip(shape, parts)):
            if cur is None and dim % dp_size == 0:
                parts[i] = dp_entry
                break
        return P(*parts)

    return tree_map(leaf, pspecs_tree, params_tree)


def param_specs(params_tree, mesh=None):
    """PartitionSpec tree matching ``params_tree`` (tensors or meta
    tensors in the reference's stacked layout).  Dims that don't divide the
    mesh axis evenly fall back to replication."""
    sizes = mesh_sizes(mesh) if mesh is not None else None
    return tree_map(lambda path, leaf: _spec_for_leaf("/".join(path), tuple(leaf.shape), sizes),
                    params_tree)

