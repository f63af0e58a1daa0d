"""AdamW with fp32 master weights, global-norm clipping and cosine schedule.

Counterpart of ``repro.training.optim``.  Functional, as there: state =
``{master, m, v, step}`` and ``update`` returns the new working params
(cast from the fp32 masters to each param's own dtype) and a new state,
leaving its inputs as they were.  Where the reference's state mirrors the
param pytree, the port's is keyed by the module's parameter names
(``"layers.3.attn.wq"``); ``ref_path`` gives each name the reference's path
string (``"layers/attn/wq"``), which the weight-decay mask reads and whose
sorted order is the reference's leaf order.  The arithmetic is the
reference's fp32, op for op and in its order.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def ref_path(name: str) -> str:
    """The reference's path string of a parameter name: the module path with
    its ``ModuleList`` indices dropped, as the reference stacks the layers
    into one leaf (``"layers.3.attn.wq"`` → ``"layers/attn/wq"``)."""
    return "/".join(part for part in name.split(".") if not part.isdigit())


def f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-dim fp32 tensor on ``like``'s device.  A divisor must be
    one: on the card torch divides by a Python number as a multiplication
    by its reciprocal, which rounds otherwise than the reference's true
    division."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _rounded(fn, *args: torch.Tensor) -> torch.Tensor:
    """``fn`` of fp32 arguments evaluated in fp64 and rounded once to fp32:
    the correctly rounded result (but for a near-tie; exactly for ``sqrt``),
    on the CPU and the card alike.  torch's fp32 ``cos``/``pow`` are within
    an ULP or two (and an ULP of ``cos`` near the schedule's end is several
    of the lr); its fp32 ``sqrt`` on the card misses the IEEE rounding by an
    ULP at about one element in 150, where the CPU's, and XLA's, round
    correctly."""
    return fn(*(a.to(torch.float64) for a in args)).to(torch.float32)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_frac·lr``."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / f32(max(cfg.warmup_steps, 1), step), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / f32(max(cfg.total_steps - cfg.warmup_steps, 1), step),
        0.0, 1.0)
    cos = 0.5 * (1 + _rounded(torch.cos, math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def init_state(params: dict[str, torch.Tensor]) -> dict:
    """fp32 copies of the params as masters, zero moments, step 0; every
    leaf on its param's device."""
    return {
        "master": {n: p.detach().to(torch.float32, copy=True) for n, p in params.items()},
        "m": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in params.items()},
        "v": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=_device(params)),
    }


def state_shapes(params: dict[str, torch.Tensor]) -> dict:
    """``init_state``'s leaves as meta tensors (shape and dtype, no storage)."""
    meta = lambda: {n: torch.empty(p.shape, dtype=torch.float32, device="meta")  # noqa: E731
                    for n, p in params.items()}
    return {"master": meta(), "m": meta(), "v": meta(),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def _device(params) -> torch.device:
    return next(iter(params.values())).device if params else torch.device("cpu")


def square_sum(g: torch.Tensor) -> torch.Tensor:
    """A leaf's (or a slice's) sum of squares in fp64."""
    return torch.sum(g.to(torch.float64) ** 2)


def norm_of_sums(leaf_sums: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of the per-leaf fp64 sums of squares (keyed by
    parameter name), the leaves in the reference's order (a stacked leaf's
    sum is its layers' sums), rounded once to fp32 before the fp32 sqrt."""
    sums: dict[str, torch.Tensor] = {}
    for name, s in leaf_sums.items():
        path = ref_path(name)
        sums[path] = s if path not in sums else sums[path] + s
    order = sorted(sums, key=lambda p: p.split("/"))
    return torch.sqrt(torch.sum(torch.stack([sums[p] for p in order])).to(torch.float32))


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """The global norm of ``tree``.  The sums run in fp64 and round once to
    fp32 before the fp32 sqrt: within an fp32 rounding of the reference's
    fp32 sums, and the same bits on the CPU and on the card, whose
    reduction orders differ."""
    return norm_of_sums({name: square_sum(g) for name, g in tree.items()})


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float,
                        norm: torch.Tensor | None = None):
    """(fp32 grads scaled by ``min(1, max_norm / max(norm, 1e-9))``, norm);
    ``norm`` is ``global_norm(grads)`` unless given (the norm of a whole
    gradient of which ``grads`` holds slices)."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(f32(max_norm, norm) / torch.clamp(norm, min=1e-9), max=1.0)
    return {n: g.to(torch.float32) * scale for n, g in grads.items()}, norm


_NO_DECAY = ("norm", "ln", "bias", "b_if", "a_log", "dt_bias", "d_skip", "scale")


def _decay_mask(path: str) -> bool:
    return not any(t in path for t in _NO_DECAY)


@torch.no_grad()
def update(opt_cfg: OptConfig, state: dict, grads: dict[str, torch.Tensor],
           param_dtypes: dict[str, torch.dtype],
           norm: torch.Tensor | None = None) -> tuple[dict[str, torch.Tensor], dict]:
    """Returns (new working params, new state).  ``param_dtypes`` maps each
    name to its param's dtype, so the working copy matches the model's
    storage dtypes.  Every op but the clip's norm is elementwise, so
    ``state`` and ``grads`` may hold slices of the leaves (a data replica's
    share) when ``norm`` gives the whole gradient's global norm."""
    step = state["step"] + 1
    lr = schedule(opt_cfg, step)
    g32, _ = clip_by_global_norm(grads, opt_cfg.clip_norm, norm)
    b1, b2 = opt_cfg.beta1, opt_cfg.beta2
    t = step.to(torch.float32)
    bc1 = 1 - _rounded(torch.pow, f32(b1, t), t)
    bc2 = 1 - _rounded(torch.pow, f32(b2, t), t)
    master, m, v = {}, {}, {}
    for name, g in g32.items():
        m[name] = b1 * state["m"][name] + (1 - b1) * g
        v[name] = b2 * state["v"][name] + (1 - b2) * g * g
        upd = (m[name] / bc1) / (_rounded(torch.sqrt, v[name] / bc2) + opt_cfg.eps)
        if _decay_mask(ref_path(name)):
            upd = upd + opt_cfg.weight_decay * state["master"][name]
        master[name] = state["master"][name] - lr * upd
    params = {n: ms.to(param_dtypes[n]) for n, ms in master.items()}
    return params, {"master": master, "m": m, "v": v, "step": step}
