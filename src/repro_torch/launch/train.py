"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/run1 [--device cpu]

Counterpart of ``repro.launch.train``, with the reference's flags and
``--device`` (default ``cuda``; no fallback to the CPU).  Synthetic data,
checkpoint/resume (kill and rerun the same command: it resumes from the
latest complete step), preemption guard, straggler monitor.  Checkpoints
hold the reference's tree ``{"params": ..., "opt": ...}`` in its layout on
disk (``models.convert``), so a run of either package resumes in the other.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.launch.specs import make_batch
from repro_torch.models.api import build_model
from repro_torch.models.common import ShapeSpec
from repro_torch.models.convert import (lm_params_from_jax, lm_params_to_tree,
                                        opt_state_from_jax, opt_state_to_tree, to_tree)
from repro_torch.training import optim
from repro_torch.training.resilience import PreemptionGuard, StragglerMonitor
from repro_torch.training.trainer import make_train_step


def synthetic_batch(cfg, batch: int, seq: int, step: int, device=None) -> dict:
    """Deterministic synthetic LM batch (markov-ish token stream): the
    reference's numpy draws, so the same bytes, ``seq`` ramped tokens a row
    (in the audio family too, beside ``seq`` frames).  In the vlm family the
    ramp covers the text tokens only (the batch's ``tokens``/``labels``
    width, after the patch prefix); the reference's ramps the whole ``seq``
    there, which its own ``loss`` refuses (``pos3`` covers ``seq``
    positions)."""
    rng = np.random.default_rng(step)
    spec = ShapeSpec("t", seq_len=seq, global_batch=batch, kind="train")
    b = make_batch(cfg, spec, seed=step, device=device)
    # make labels learnable: next-token of a periodic sequence
    if "tokens" in b and "labels" in b:
        base = rng.integers(0, cfg.vocab, size=(batch, 1))
        width = b["tokens"].shape[1] if cfg.family == "vlm" else seq
        ramp = (base + np.arange(width)[None, :]) % cfg.vocab
        dev = b["tokens"].device
        b["tokens"] = torch.as_tensor(ramp.astype(np.int32), device=dev)
        b["labels"] = torch.as_tensor(((ramp + 1) % cfg.vocab).astype(np.int32), device=dev)
    return b


def checkpoint_tree(model, opt_state) -> dict:
    """What a training checkpoint holds: the reference's tree."""
    return {"params": lm_params_to_tree(model), "opt": opt_state_to_tree(opt_state)}


def restore_into(mgr: CheckpointManager, model, step: int | None = None) -> dict:
    """Load ``mgr``'s latest (or ``step``'s) checkpoint into ``model``'s
    params; returns the restored optimizer state.  The like-tree is meta
    tensors (``optim.state_shapes``), so nothing is allocated for it."""
    meta = {n: p.detach().to("meta") for n, p in model.named_parameters()}
    like = {"params": to_tree(meta), "opt": opt_state_to_tree(optim.state_shapes(meta))}
    state = mgr.restore(like, step=step, device=model.device)
    lm_params_from_jax(model, state["params"])
    return opt_state_from_jax(model, state["opt"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=args.device, seed=args.seed)
    opt_cfg = optim.OptConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches)
    opt_state = optim.init_state(dict(model.named_parameters()))
    start = 0

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr is not None and mgr.latest_step() is not None:
        start = mgr.latest_step()
        opt_state = restore_into(mgr, model)
        print(f"[resume] from step {start}")

    guard = PreemptionGuard()
    monitor = StragglerMonitor()
    losses = []
    for step in range(start, args.steps):
        monitor.start_step()
        batch = synthetic_batch(cfg, args.batch, args.seq, step, device=model.device)
        opt_state, loss, metrics = step_fn(opt_state, batch)
        losses.append(float(loss))  # waits for the step
        ev = monitor.end_step()
        if ev:
            print(f"[straggler] step {ev.step}: {ev.seconds:.2f}s "
                  f"(median {ev.median:.2f}s)")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f}", flush=True)
        if mgr is not None and ((step + 1) % args.ckpt_every == 0
                                or guard.requested or step == args.steps - 1):
            mgr.save_async(step + 1, checkpoint_tree(model, opt_state))
        if guard.requested:
            print("[preempt] checkpointed, exiting cleanly")
            break
    if mgr is not None:
        mgr.wait()
    guard.restore()
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
