#!/usr/bin/env python3
"""How far apart do δ-stopped ``bsr`` and ``ref`` solves stop, in the port and
in the JAX package, on the same problems?  A CPU script.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/bsr_ref_gap.py \
        [--vertices 5000 10000 20000] [--batch 5000] [--seeds 42]

For each size and seed it streams ``gaussian_mixture_stream`` (the paper's
90/1/9 protocol, ``emb_dim=16``, kNN ``k=5``) through the port's
``DynLP`` on the CPU and keeps the last batch's solve inputs (the problem,
F0 and the frontier).  It then solves them again with ``δ = 1e-4``:
the port's ``ref`` and one-shot ``bsr`` and the reference's ``ref`` and
one-shot ``bsr``.  The reference's Pallas SpMV takes minutes a solve in
interpret mode on the CPU, so its ``bsr`` solve runs with the SpMV swapped
for ``xla_bsr_spmv`` below: the kernel's own loop (tile slots in order,
each a float32 dot of a tile with its column block), held against one
interpret-mode call of the kernel first.  It prints each solve's sweeps
and each pair's largest |ΔF| over the valid rows, in units of δ.  The port's pair is the one whose gap on the card
was 20.15·δ at 100,000 vertices; the reference's pair says whether the
stopping rule or the port is behind such a gap.  The last line is a JSON
record of every number printed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

sys.path.insert(0, "src")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.propagate import PropagationProblem as JaxProblem  # noqa: E402
from repro.core.propagate import propagate as jax_ref  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels.bsr_spmv import bsr_spmv as pallas_bsr_spmv  # noqa: E402
from repro.kernels.ops import propagate_bsr as jax_bsr  # noqa: E402
from repro_torch.core import dynlp as dynlp_module  # noqa: E402
from repro_torch.core.dynlp import DynLP  # noqa: E402
from repro_torch.core.propagate import propagate  # noqa: E402
from repro_torch.data.synth import StreamSpec, gaussian_mixture_stream  # noqa: E402
from repro_torch.graph.dynamic import DynamicGraph  # noqa: E402
from repro_torch.kernels.ops import propagate_bsr, run_propagation  # noqa: E402

DELTA = 1e-4


def last_solve(vertices: int, batch: int, seed: int) -> dict:
    """The port's DynLP over the stream; the last batch's solve inputs."""
    spec = StreamSpec(total_vertices=vertices, batch_size=batch, seed=seed,
                      class_sep=6.0, noise=0.9)
    kept = {}

    def keep(problem, f0, frontier0, **kw):
        kept.update(problem=problem, f0=f0.clone(), frontier0=frontier0.clone())
        return run_propagation(problem, f0, frontier0, **kw)

    dynlp_module.run_propagation = keep
    try:
        dyn = DynLP(DynamicGraph(emb_dim=spec.emb_dim, k=5), delta=DELTA, device="cpu")
        for b, _ in gaussian_mixture_stream(spec):
            dyn.step(b)
    finally:
        dynlp_module.run_propagation = run_propagation
    return kept


@jax.jit
def xla_bsr_spmv(blocks, block_cols, x, interpret=True):
    """The reference kernel's loop in XLA: per block row, the tile slots in
    order, each adding ``dot(tile, x[col block])`` where its column is set."""
    r, _, bs, _ = blocks.shape
    xb = x.reshape(-1, bs)

    def slot(y, j):
        a, c = blocks[:, j], block_cols[:, j]
        d = jnp.einsum("rab,rb->ra", a.astype(jnp.float32),
                       xb[jnp.maximum(c, 0)].astype(jnp.float32))
        return jnp.where((c >= 0)[:, None], y + d, y), None

    y, _ = jax.lax.scan(slot, jnp.zeros((r, bs), jnp.float32),
                        jnp.arange(blocks.shape[1]))
    return y.reshape(-1)


def check_twin(seed=0, r=64, j=6, bs=8):
    """``xla_bsr_spmv`` against the interpret-mode kernel on one product."""
    rng = np.random.default_rng(seed)
    blocks = jnp.asarray(rng.uniform(0, 1, (r, j, bs, bs)).astype(np.float32))
    cols = rng.integers(0, r, (r, j)).astype(np.int32)
    cols[rng.uniform(size=(r, j)) < 0.3] = -1
    x = jnp.asarray(rng.uniform(0, 1, r * bs).astype(np.float32))
    want = np.asarray(pallas_bsr_spmv(blocks, jnp.asarray(cols), x, interpret=True))
    got = np.asarray(xla_bsr_spmv(blocks, jnp.asarray(cols), x))
    return float(np.abs(got - want).max())


def gap(a, b, valid):
    return float(np.abs(a - b)[valid].max()) / DELTA


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vertices", type=int, nargs="+", default=[5000, 10000, 20000])
    ap.add_argument("--batch", type=int, default=5000)
    ap.add_argument("--seeds", type=int, nargs="+", default=[42])
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    twin = check_twin()
    print(f"xla_bsr_spmv vs the interpret-mode kernel: max|dy| {twin:.2e}")
    jax_ops.bsr_spmv = xla_bsr_spmv
    rows = []
    for n, seed in ((n, seed) for n in args.vertices for seed in args.seeds):
        t0 = time.perf_counter()
        k = last_solve(n, min(args.batch, n), seed)
        p, f0, fr = k["problem"], k["f0"], k["frontier0"]
        valid = p.valid.numpy()
        solves = {
            "port ref": propagate(p, f0, fr, delta=DELTA),
            "port bsr": propagate_bsr(p, f0, fr, delta=DELTA),
        }
        jp = JaxProblem(*(jnp.asarray(t.numpy()) for t in (p.nbr, p.wgt, p.wl0, p.wl1,
                                                          p.valid)))
        jf0, jfr = jnp.asarray(f0.numpy()), jnp.asarray(fr.numpy())
        solves["jax ref"] = jax_ref(jp, jf0, jfr, delta=DELTA)
        solves["jax bsr"] = jax_bsr(jp, jf0, jfr, delta=DELTA)
        f = {name: np.asarray(r.f) for name, r in solves.items()}
        row = dict(vertices=n, seed=seed, rows=int(valid.sum()), k=int(p.nbr.shape[1]),
                   frontier=int(fr.sum()),
                   sweeps={name: int(r.iterations) for name, r in solves.items()},
                   gap_port_bsr_ref=gap(f["port bsr"], f["port ref"], valid),
                   gap_jax_bsr_ref=gap(f["jax bsr"], f["jax ref"], valid),
                   gap_ref_port_jax=gap(f["port ref"], f["jax ref"], valid),
                   gap_bsr_port_jax=gap(f["port bsr"], f["jax bsr"], valid),
                   seconds=round(time.perf_counter() - t0, 1))
        rows.append(row)
        print(f"N={n} seed {seed}: {row['rows']} rows, K={row['k']}, frontier {row['frontier']}; "
              f"sweeps {row['sweeps']}; max|dF|/delta: port bsr-ref "
              f"{row['gap_port_bsr_ref']:.3f}, jax bsr-ref {row['gap_jax_bsr_ref']:.3f}, "
              f"ref port-jax {row['gap_ref_port_jax']:.3f}, bsr port-jax "
              f"{row['gap_bsr_port_jax']:.3f} ({row['seconds']} s)", flush=True)
    print(json.dumps({"delta": DELTA, "twin_max_abs_diff": twin, "sizes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
