"""Train-step factory: loss → grad → clip → AdamW, with optional microbatch
gradient accumulation (a memory knob).

Counterpart of ``repro.training.trainer``'s ``make_train_step`` and
``make_eval_step``.  The model is any ``nn.Module`` whose ``loss(batch)``
returns ``(loss, metrics)``; the step takes its gradients with autograd,
clips and updates through ``training.optim`` and writes the new working
params into the module.  The reference's ``grad_specs`` (a sharding
constraint on the gradients) and ``unroll_micro`` (static slices in place
of ``lax.scan``, an XLA partitioner workaround) are identities on values
and have no counterpart here.  ``make_hybrid_train_step`` is the
reference's manual data parallelism over a ``launch.mesh.NamedMesh``: each
data replica takes its slice of the batch, one fp32 scatter-mean a leaf
along the leaf's ZeRO spec (``distribution.partition.zero_specs``), the
optimizer on each replica's share, the new params gathered back.
"""

from __future__ import annotations

import copy
import math
from typing import Callable

import numpy as np
import torch
from torch import nn

from repro_torch.distribution import partition
from repro_torch.models.convert import _ref_key, _stack_counts
from repro_torch.training import optim


def split(batch: dict, microbatches: int) -> list[dict]:
    """The batch's leading dim cut into ``microbatches`` equal parts, as the
    reference's ``split``: a 0-dim leaf goes to every part whole, a
    ``(3, B, S)`` leaf (``pos3``) is cut along B."""
    def cut(x):
        if x.ndim == 0:
            return [x] * microbatches
        b = x.shape[0]
        if x.ndim >= 2 and b == 3 and x.shape[1] % microbatches == 0:
            return list(x.reshape(3, microbatches, x.shape[1] // microbatches,
                                  *x.shape[2:]).movedim(1, 0))
        if b % microbatches:
            raise ValueError(f"batch dim {b} does not split into {microbatches} microbatches")
        return list(x.reshape(microbatches, b // microbatches, *x.shape[1:]))

    parts = {k: cut(x) for k, x in batch.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(microbatches)]


def _grads_fn(model: nn.Module):
    """(the module's parameters by name, marked as needing grad;
    ``grads_of(batch) -> (loss, metrics, grads in name order)``)."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    names = list(params)

    def grads_of(batch):
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), {k: m.detach() for k, m in metrics.items()}, grads

    return params, grads_of


def _accumulate(grads_of, batch: dict, microbatches: int):
    """(mean loss, mean metrics, the per-microbatch gradients summed in each
    param's own dtype) over ``batch`` cut into ``microbatches``."""
    acc, lsum, mets = None, None, []
    for mb in split(batch, microbatches):
        l, met, g = grads_of(mb)
        acc = g if acc is None else [a + b for a, b in zip(acc, g)]
        del g  # the next backward runs beside the sum alone
        lsum = l if lsum is None else lsum + l
        mets.append(met)
    loss = lsum / optim.f32(microbatches, lsum)
    return loss, {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}, acc


def make_train_step(model: nn.Module, opt_cfg: optim.OptConfig,
                    microbatches: int = 1) -> Callable:
    """Returns ``train_step(opt_state, batch) -> (opt_state, loss, metrics)``.

    It marks the module's parameters as needing grad.  With
    ``microbatches > 1`` the per-microbatch gradients are summed in each
    param's own dtype (bf16 for a bf16 model) and divided by the count in
    fp32 after the loop, as the reference's ``lax.scan`` accumulator does;
    each microbatch's loss is not scaled before its backward, so the
    gradients round as there."""
    params, grads_of = _grads_fn(model)
    names = list(params)
    dtypes = {n: p.dtype for n, p in params.items()}

    def train_step(opt_state: dict, batch: dict):
        if microbatches <= 1:
            loss, metrics, g = grads_of(batch)
            grads = dict(zip(names, g))
        else:
            loss, metrics, acc = _accumulate(grads_of, batch, microbatches)
            n = optim.f32(microbatches, loss)
            grads = {name: a.to(torch.float32) / n for name, a in zip(names, acc)}
        new_params, opt_state = optim.update(opt_cfg, opt_state, grads, dtypes)
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(new_params[name])
        return opt_state, loss, metrics

    return train_step


def make_eval_step(model: nn.Module) -> Callable:
    def eval_step(batch):
        with torch.no_grad():
            return model.loss(batch)

    return eval_step


def _dp_dim(spec, dp_set: set) -> int | None:
    """The dim of ``spec`` whose entry names a data-parallel axis, or None."""
    for i, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if entry is not None and {a for a in axes if a} & dp_set:
            return i
    return None


def _replica_slice(x: torch.Tensor, spec, dp_set: set, r: int, n_rep: int) -> torch.Tensor:
    """Replica ``r``'s block of ``x`` along the dim ``spec`` shards over the
    dp axes (``x`` whole where none)."""
    dim = _dp_dim(spec, dp_set)
    if dim is None:
        return x
    n = x.shape[dim] // n_rep
    assert n * n_rep == x.shape[dim], (x.shape, spec, n_rep)
    return x.narrow(dim, r * n, n)


def _blocks(params: dict, zspecs, dp_set: set, n_rep: int) -> dict:
    """Per parameter name: (kind, [(replica, region)]) from its stacked
    leaf's ZeRO spec.  "scatter": the dp dim is one of the param's own, and
    each replica owns a slice of it (``region`` the index tuple); "owner":
    the dp dim is a stacked one, and the replica whose block holds this
    param's index there owns it whole (``region`` None); "mean": no dp dim,
    every replica holds the whole mean (updated once, by replica 0)."""
    counts = _stack_counts(params)
    out = {}
    for name, p in params.items():
        key, index = _ref_key(name)
        spec = zspecs
        for part in key:
            spec = spec[part]
        dim = _dp_dim(spec, dp_set) if n_rep > 1 else None
        if dim is None:
            out[name] = ("mean", [(0, None)])
        elif dim < len(index):
            out[name] = ("owner", [(index[dim] // (counts[key][dim] // n_rep), None)])
        else:
            d, n = dim - len(index), p.shape[dim - len(index)] // n_rep
            out[name] = ("scatter", [(r, (slice(None),) * d + (slice(r * n, (r + 1) * n),))
                                     for r in range(n_rep)])
    return out


def make_hybrid_train_step(model: nn.Module, opt_cfg: optim.OptConfig, mesh, zspecs,
                           batch_inspecs: dict, microbatches: int = 1,
                           dp_axes: tuple = ("data",), pspecs=None) -> Callable:
    """Manual data parallelism over ``mesh``'s ``dp_axes`` (the reference's
    ``make_hybrid_train_step``).  Returns ``train_step(opt_state, batch) ->
    (opt_state, loss, metrics)`` on ``optim.init_state``'s state, as
    ``make_train_step``'s does.

    Each of the D data replicas takes its block of the batch along the dim
    ``batch_inspecs`` (a ``PartitionSpec`` a batch key) shards over the dp
    axes, and accumulates its own gradients over layers and
    ``microbatches`` (summed and divided by the count in each param's
    dtype, as the reference's ``shard_map`` body does).  Then one fp32
    scatter-mean a leaf (the reference's ``trainer.py:189-200``):
    ``zspecs``, the ZeRO spec tree in the reference's stacked layout
    (``partition.zero_specs``), names the leaf's dim that the dp axes
    split; a replica owns its block of that dim (a whole layer when the
    dim is a stacked one), sums every replica's gradient there in replica
    order and divides by D; a leaf with no dp dim is averaged whole
    (``pmean``).  The optimizer updates each replica's block of master, m
    and v (the clip's norm is the whole gradient's, its fp64 square sums
    added over the blocks), and the new params are gathered back into
    every replica's module.

    One module per distinct device of the replicas: ``model`` on its own
    device, a copy on each other; replicas on one device share its module
    and run one after another.  The axes outside ``dp_axes`` (tensor
    parallelism, left to XLA's partitioner inside the reference's manual
    region) change no value and run as replication, so ``pspecs`` is
    accepted and unused.  ``train_step.bytes`` counts, summed over the
    steps, what the exchange moves between replicas: "scatter" (each
    replica receives the other D−1 replicas' fp32 gradients of its blocks;
    a pmean leaf, D−1 whole copies) and "gather" (each replica receives the
    new params of the blocks the others own).
    """
    dp_axes = tuple(dp_axes)
    dp_set = set(dp_axes)
    sizes = partition.mesh_sizes(mesh)
    n_rep = math.prod(sizes[a] for a in dp_axes)
    first = [mesh.axis_names.index(a) for a in dp_axes]
    rep_devs = list(np.moveaxis(mesh.devices, first, list(range(len(first))))
                    .reshape(n_rep, -1)[:, 0])
    modules = {model.device: model}
    for dev in rep_devs:
        if dev not in modules:
            modules[dev] = copy.deepcopy(model).to(dev)
    fns = {dev: _grads_fn(m) for dev, m in modules.items()}
    params = fns[model.device][0]
    names = list(params)
    dtypes = {n: p.dtype for n, p in params.items()}
    owned = [{} for _ in range(n_rep)]  # per replica: {name: its region, None for whole}
    scatter_bytes = gather_bytes = 0  # a step's
    for name, (kind, parts) in _blocks(params, zspecs, dp_set, n_rep).items():
        block = params[name].numel() // len(parts) if kind == "scatter" else params[name].numel()
        for r, region in parts:
            owned[r][name] = region
            scatter_bytes += (n_rep if kind == "mean" else 1) * (n_rep - 1) * block * 4
            if kind != "mean":
                gather_bytes += (n_rep - 1) * block * params[name].element_size()
    home = model.device

    def local(r, batch):
        dev = rep_devs[r]
        part = {k: _replica_slice(x, batch_inspecs[k], dp_set, r, n_rep).to(dev)
                for k, x in batch.items()}
        grads_of = fns[dev][1]
        if microbatches <= 1:
            return grads_of(part)
        loss, metrics, acc = _accumulate(grads_of, part, microbatches)
        return loss, metrics, [a / torch.full((), microbatches, dtype=a.dtype, device=a.device)
                               for a in acc]

    def mean(xs):
        total = xs[0]
        for x in xs[1:]:
            total = total + x.to(total.device)
        return total / optim.f32(n_rep, total)

    def train_step(opt_state: dict, batch: dict):
        outs = [local(r, batch) for r in range(n_rep)]
        loss = mean([o[0] for o in outs]).to(home)
        metrics = {k: mean([o[1][k] for o in outs]).to(home) for k in outs[0][1]}
        grads = [dict(zip(names, o[2])) for o in outs]
        del outs
        mine = [{name: mean([(g[name] if region is None else g[name][region])
                             .to(rep_devs[r], torch.float32) for g in grads])
                 for name, region in owned[r].items()} for r in range(n_rep)]
        del grads
        sums = {}
        for blocks in mine:
            for name, g in blocks.items():
                s = optim.square_sum(g).to(home)
                sums[name] = s if name not in sums else sums[name] + s
        norm = optim.norm_of_sums(sums)
        new = {key: {} for key in ("params", "master", "m", "v")}
        for r in range(n_rep):
            if not owned[r]:
                continue
            dev = rep_devs[r]
            sub = {key: {name: (opt_state[key][name] if region is None
                                else opt_state[key][name][region]).to(dev)
                         for name, region in owned[r].items()}
                   for key in ("master", "m", "v")}
            sub["step"] = opt_state["step"].to(dev)
            p_r, s_r = optim.update(opt_cfg, sub, mine[r], dtypes, norm.to(dev))
            mine[r] = None
            for key, part in (("params", p_r), ("master", s_r["master"]), ("m", s_r["m"]),
                              ("v", s_r["v"])):
                for name, region in owned[r].items():
                    if region is None:
                        new[key][name] = part[name].to(home)
                        continue
                    if name not in new[key]:
                        like = params[name] if key == "params" else opt_state[key][name]
                        new[key][name] = torch.empty_like(like)
                    new[key][name][region] = part[name]
        with torch.no_grad():
            for dev_params, _ in fns.values():
                for name, p in dev_params.items():
                    p.copy_(new["params"][name])
        state = {key: {name: new[key][name] for name in names} for key in ("master", "m", "v")}
        state["step"] = opt_state["step"] + 1
        train_step.bytes["scatter"] += scatter_bytes
        train_step.bytes["gather"] += gather_bytes
        return state, loss, metrics

    train_step.bytes = {"scatter": 0, "gather": 0}
    return train_step
