"""End-to-end driver on the PyTorch/CUDA port: DynLP pseudo-labeling feeding
LM training.

    PYTHONPATH=src python examples/torch_semi_supervised_lm.py \
        [--arch qwen3-0.6b] [--steps 200] [--ckpt-dir /tmp/ssl_run] [--device cpu]

The port of ``examples/semi_supervised_lm.py``.  Documents stream in with
2% domain labels; DynLP (on the card, through the sweep kernel) labels the
rest on a dynamic kNN graph; only confidently domain-A documents feed the
LM train loop (semi-supervised data curation).  Checkpoints every N steps
(rerun the same command after a kill to resume), straggler monitor,
preemption guard.  With ``--full-config`` it trains the published config
(qwen3-0.6b: 751,632,384 parameters, bf16 weights from a seeded
generator); the default reduced config trains on the CPU.  Without
``--device`` it runs on ``cuda``.
"""

import argparse

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.data.pipeline import PseudoLabelPipeline
from repro_torch.data.synth import make_documents
from repro_torch.launch.train import checkpoint_tree, restore_into
from repro_torch.models.api import build_model
from repro_torch.training import optim
from repro_torch.training.resilience import PreemptionGuard, StragglerMonitor
from repro_torch.training.trainer import make_train_step

WAVES = 3


def curate(rng, vocab, device, docs_per_wave=400, seq=64):
    """Stage 1: stream ``WAVES`` waves of documents through the DynLP
    pipeline on ``device``; select the confident domain-A ones."""
    pipe = PseudoLabelPipeline(k=5, device=device)
    truth, sweeps = {}, 0
    for wave in range(WAVES):
        toks, labels, cls = make_documents(rng, docs_per_wave, seq, vocab)
        base = pipe.graph.num_nodes
        st = pipe.ingest(toks, labels)
        truth.update({base + i: c for i, c in enumerate(cls)})
        sweeps += st.lp_iterations
        print(f"wave {wave}: {st.num_docs} docs labeled in "
              f"{st.lp_iterations} LP iterations ({st.lp_ms:.0f} ms)")
    quality = pipe.label_quality(truth)
    print(f"pseudo-label accuracy vs latent domain: {quality:.3f}")
    ids, curated = pipe.select(target_class=1, confidence=0.7)
    purity = float(np.mean([truth[i] == 1 for i in ids]))
    print(f"curated {len(ids)} domain-A documents (purity {purity:.3f})")
    return dict(curated=curated, quality=quality, purity=purity, sweeps=sweeps)


def train(model, curated, rng, steps=200, train_batch=8, ckpt_dir=None, ckpt_every=50):
    """Stage 2: train ``model`` on batches of curated documents (next-token
    labels); returns (optimizer state, the losses of the steps run)."""
    opt_cfg = optim.OptConfig(lr=3e-3, warmup_steps=10, total_steps=steps)
    step_fn = make_train_step(model, opt_cfg)
    opt_state = optim.init_state(dict(model.named_parameters()))
    start = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr and mgr.latest_step() is not None:
        start = mgr.latest_step()
        opt_state = restore_into(mgr, model)
        print(f"[resume] from step {start}")

    guard, monitor = PreemptionGuard(), StragglerMonitor()
    losses = []
    for step in range(start, steps):
        monitor.start_step()
        idx = rng.integers(0, len(curated), size=train_batch)
        batch = {
            "tokens": torch.as_tensor(curated[idx], dtype=torch.int32, device=model.device),
            "labels": torch.as_tensor(np.roll(curated[idx], -1, axis=1), dtype=torch.int32,
                                      device=model.device),
        }
        opt_state, loss, _ = step_fn(opt_state, batch)
        losses.append(float(loss))  # waits for the step
        if monitor.end_step():
            print(f"[straggler] at step {step}")
        if step % 25 == 0 or step == steps - 1:
            print(f"step {step:4d} loss {losses[-1]:.4f}", flush=True)
        if mgr and ((step + 1) % ckpt_every == 0 or guard.requested):
            mgr.save_async(step + 1, checkpoint_tree(model, opt_state))
        if guard.requested:
            print("[preempt] checkpointed; exiting")
            break
    if mgr:
        mgr.wait()
    guard.restore()
    return opt_state, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--train-batch", type=int, default=8)
    ap.add_argument("--docs-per-wave", type=int, default=400)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full_config else get_smoke_config(args.arch)
    model = build_model(cfg, device=args.device)
    rng = np.random.default_rng(0)
    cur = curate(rng, cfg.vocab, model.device, args.docs_per_wave, args.seq)
    _, losses = train(model, cur["curated"], rng, args.steps, args.train_batch,
                      args.ckpt_dir, args.ckpt_every)
    first, last = losses[0], losses[-1]
    print(f"loss {first:.3f} -> {last:.3f} on DynLP-curated data")
    assert cur["quality"] > 0.9 and cur["purity"] > 0.9 and last < first
    return dict(cur, losses=losses)


if __name__ == "__main__":
    main()
