"""Train-step factory: loss → grad → clip → AdamW, with optional microbatch
gradient accumulation (a memory knob).

Counterpart of ``repro.training.trainer``'s ``make_train_step`` and
``make_eval_step``.  The model is any ``nn.Module`` whose ``loss(batch)``
returns ``(loss, metrics)``; the step takes its gradients with autograd,
clips and updates through ``training.optim`` and writes the new working
params into the module.  The reference's ``grad_specs`` (a sharding
constraint on the gradients) and ``unroll_micro`` (static slices in place
of ``lax.scan``, an XLA partitioner workaround) are identities on values
and have no counterpart here; ``make_hybrid_train_step`` needs the
partition spec trees of ``distribution/partition.py`` and waits for that
module (``ROADMAP.md`` queue 1, item 11).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

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


def make_train_step(model: nn.Module, opt_cfg: optim.OptConfig,
                    microbatches: int = 1) -> Callable:
    """Returns ``train_step(opt_state, batch) -> (opt_state, loss, metrics)``.

    It marks the module's parameters as needing grad.  With
    ``microbatches > 1`` the per-microbatch gradients are summed in each
    param's own dtype (bf16 for a bf16 model) and divided by the count in
    fp32 after the loop, as the reference's ``lax.scan`` accumulator does;
    each microbatch's loss is not scaled before its backward, so the
    gradients round as there."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    names = list(params)
    dtypes = {n: p.dtype for n, p in params.items()}

    def grads_of(batch):
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), {k: m.detach() for k, m in metrics.items()}, grads

    def train_step(opt_state: dict, batch: dict):
        if microbatches <= 1:
            loss, metrics, g = grads_of(batch)
            grads = dict(zip(names, g))
        else:
            acc, lsum, mets = None, None, []
            for mb in split(batch, microbatches):
                l, met, g = grads_of(mb)
                acc = g if acc is None else [a + b for a, b in zip(acc, g)]
                lsum = l if lsum is None else lsum + l
                mets.append(met)
            n = optim.f32(microbatches, lsum)
            grads = {name: a.to(torch.float32) / n for name, a in zip(names, acc)}
            loss = lsum / n
            metrics = {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}
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
