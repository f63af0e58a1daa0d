"""Quickstart on the PyTorch/CUDA port: DynLP on an evolving similarity graph.

    PYTHONPATH=src python examples/torch_quickstart.py               # on the GPU
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Streams batches of embedded data points (90% unlabeled / 1% labeled / 9%
deletions, the paper's protocol), keeps the labels current incrementally
with DynLP, and compares against full recomputation (ITLP) and the exact
harmonic solution (STLP's dense solve).  The port of
``examples/quickstart.py``.
"""

import argparse

import numpy as np

from repro_torch.core.dynlp import DynLP
from repro_torch.core.itlp import ITLP
from repro_torch.core.snapshot import build_problem
from repro_torch.core.stlp import harmonic_solve
from repro_torch.data.synth import StreamSpec, accuracy, gaussian_mixture_stream
from repro_torch.graph.dynamic import UNLABELED, DynamicGraph


def main(device="cuda", vertices=3_000, batch_size=600):
    """Runs the three methods on one stream; returns the accuracy against
    the ground truth, the agreement with the harmonic optimum and both
    methods' total iterations."""
    spec = StreamSpec(total_vertices=vertices, batch_size=batch_size, seed=42,
                      class_sep=6.0, noise=0.9)

    print(f"== DynLP (incremental), on {device} ==")
    g = DynamicGraph(emb_dim=spec.emb_dim, k=5)
    dyn = DynLP(g, delta=1e-4, device=device)
    truth = {}
    dyn_iters = 0
    for t, (batch, cls) in enumerate(gaussian_mixture_stream(spec)):
        base = g.num_nodes
        st = dyn.step(batch)
        dyn_iters += st.iterations
        for i, c in enumerate(cls):
            truth[base + i] = c
        print(f"  batch {t}: +{len(batch.ins_labels)} vertices, "
              f"-{len(batch.del_ids)} deletions | affected={st.frontier_size} "
              f"components={st.num_components} iterations={st.iterations} "
              f"({st.wall_ms:.0f} ms)")

    ids = np.flatnonzero(g.alive & (g.labels == UNLABELED))
    pred = (g.f[ids] >= 0.5).astype(np.int8)
    acc = accuracy(pred, np.array([truth[i] for i in ids]))
    print(f"  accuracy vs ground truth: {acc:.4f}")

    print("== ITLP (full recompute per batch) ==")
    itl = ITLP(DynamicGraph(emb_dim=spec.emb_dim, k=5), delta=1e-4, device=device)
    itl_iters = sum(itl.step(batch).iterations for batch, _ in gaussian_mixture_stream(spec))
    print(f"  total iterations: ITLP={itl_iters} vs DynLP={dyn_iters} "
          f"({itl_iters / max(dyn_iters, 1):.1f}x more)")

    print("== exact harmonic solution (STLP/Wagner reference) ==")
    snap = build_problem(g, device=device)
    f_h = harmonic_solve(snap.problem)[: len(snap.unl_ids)].cpu().numpy()
    agree = accuracy(pred, (f_h >= 0.5).astype(np.int8))
    print(f"  DynLP agreement with harmonic optimum: {agree:.4f}")
    assert agree > 0.97
    return dict(accuracy=acc, agreement=agree, dynlp_iterations=dyn_iters,
                itlp_iterations=itl_iters)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
