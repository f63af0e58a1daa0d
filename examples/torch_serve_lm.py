"""Batched LM serving with continuous batching, on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_serve_lm.py [--arch qwen3-0.6b]   # on the GPU
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

The port of ``examples/serve_lm.py``: serves a (reduced-config) model with
the slot-pool engine; requests with different prompt lengths and budgets
stream through a fixed decode pool, each slot tracking its own cache
position.  The model's bf16 weights are drawn from a seeded generator.
"""

import argparse
import time

import numpy as np

from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Request, ServeEngine


def main(device="cuda", arch="qwen3-0.6b", requests=6, pool=4):
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device=device)
    engine = ServeEngine(model, max_batch=pool, s_max=64)

    rng = np.random.default_rng(0)
    reqs = [
        Request(uid=i,
                prompt=rng.integers(0, cfg.vocab, size=rng.integers(3, 9)),
                max_new=int(rng.integers(4, 10)))
        for i in range(requests)
    ]
    t0 = time.perf_counter()
    done = engine.run(reqs)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.out) for r in done)
    print(f"served {len(done)}/{len(reqs)} requests, {total_tokens} tokens "
          f"in {dt:.1f}s over {engine.steps} pooled decode steps on {model.device}")
    for r in done:
        print(f"  req {r.uid}: prompt[{len(r.prompt)}] -> {r.out}")
    assert len(done) == len(reqs)
    assert all(len(r.out) == r.max_new for r in done)
    return engine, done


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--pool", type=int, default=4)
    args = ap.parse_args()
    main(args.device, args.arch, args.requests, args.pool)
