"""Label-propagation serving front-end on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_serve_lp.py               # on the GPU
    PYTHONPATH=src python examples/torch_serve_lp.py --device cpu

The port of ``examples/serve_lp.py``, its inline assertions included:

0. The sklearn-style ``DynLabelPropagation`` estimator: ``fit`` /
   ``partial_fit`` / ``predict`` over raw embeddings.
1. ``LPService`` over a ``StreamEngine`` with mixed traffic: mutations
   through ``add_points`` / ``remove_points``, coalesced per admission
   window, and query bursts answered from the last committed snapshot.
2. The consistency contract: while a batch's solve is in flight the
   service answers from the previous commit (its new vertices do not exist
   yet); after ``sync()`` the same query sees them labeled.
3. Backpressure: a service with a small queue bound set to reject sheds a
   mutation with ``Backpressure`` instead of queueing without bound.
4. The background driver (``with svc:``): admission deadlines fire with no
   caller traffic, concurrent readers' tickets fuse into one device
   gather, and ``close()`` drains everything on exit.
"""

import argparse

import numpy as np

from repro_torch.core.stream import StreamEngine
from repro_torch.data.synth import StreamSpec, gaussian_mixture_stream
from repro_torch.graph.dynamic import UNLABELED, DynamicGraph
from repro_torch.serving.estimator import DynLabelPropagation
from repro_torch.serving.lp_service import Backpressure, LPService


def estimator_quickstart(device="cuda"):
    """Two gaussian clouds, three labeled points per class, the rest
    inferred; then more points streamed in with ``partial_fit``."""
    rng = np.random.default_rng(0)
    n = 200
    X = np.concatenate([rng.normal(-2, 0.7, (n // 2, 8)),
                        rng.normal(+2, 0.7, (n // 2, 8))]).astype(np.float32)
    truth = np.repeat([0, 1], n // 2).astype(np.int8)
    y = np.full(n, UNLABELED, np.int8)
    y[[0, 1, 2, n - 3, n - 2, n - 1]] = truth[[0, 1, 2, n - 3, n - 2, n - 1]]

    clf = DynLabelPropagation(k=5, engine_opts={"device": device}).fit(X, y)
    acc = (clf.transduction_ == truth).mean()
    Xq = np.concatenate([rng.normal(-2, 0.7, (20, 8)),
                         rng.normal(+2, 0.7, (20, 8))]).astype(np.float32)
    pred = clf.predict(Xq)  # inductive: unseen embeddings
    clf.partial_fit(Xq, np.full(len(Xq), UNLABELED, np.int8))  # stream in
    print(f"estimator quickstart: transductive acc {acc:.3f} with "
          f"{int((y != UNLABELED).sum())}/{n} seeds; predict() labeled "
          f"{len(pred)} unseen points; graph now {clf.graph_.num_alive} "
          f"vertices after partial_fit\n")
    return acc


def serving_demo(device="cuda", vertices=900, batch_size=60):
    spec = StreamSpec(total_vertices=vertices, batch_size=batch_size, seed=0,
                      class_sep=6.0, noise=0.9)
    g = DynamicGraph(emb_dim=spec.emb_dim, k=5)
    svc = LPService(StreamEngine(g, delta=1e-4, device=device),
                    window_ops=2 * spec.batch_size, window_ms=1e9,
                    max_pending_ops=16 * spec.batch_size)
    rng = np.random.default_rng(1)
    for batch, _ in gaussian_mixture_stream(spec):
        base = g.num_nodes
        # each stream batch arrives as a few typed mutations in one window;
        # the service derives the graph delta from the embeddings
        n = len(batch.ins_emb)
        svc.add_points(batch.ins_emb[:n // 2], batch.ins_labels[:n // 2])
        if len(batch.del_ids):
            svc.remove_points(batch.del_ids)
        svc.add_points(batch.ins_emb[n // 2:], batch.ins_labels[n // 2:])
        svc.flush()  # admit: the solve is now in flight

        # reads never wait for the in-flight solve: this batch's vertices
        # are invisible until it commits
        probe = np.arange(base, min(base + 3, g.num_nodes))
        r = svc.query(probe)
        assert (r.pred == UNLABELED).all() and (r.confidence == 0).all()
        burst = rng.integers(0, max(1, svc.committed_view().num_nodes), 64)
        svc.query(burst)

        svc.sync()  # read-your-writes from here on
        r = svc.query(probe)
        assert (r.confidence > 0).all()
    st = svc.stats()
    print(f"served {st.queries} query calls ({st.query_nodes} node lookups, "
          f"{st.queries_while_inflight} mid-flight) against "
          f"{st.mutations} mutations in {st.batches_committed} windows | "
          f"commit p50={st.commit_latency_ms['p50']:.1f} ms "
          f"p95={st.commit_latency_ms['p95']:.1f} ms | "
          f"{st.recompiles} rung allocations over {st.bucket_rungs} bucket rungs\n")
    return st


def backpressure_demo(device="cuda"):
    rng = np.random.default_rng(2)
    g = DynamicGraph(emb_dim=8, k=3)
    svc = LPService(StreamEngine(g, delta=1e-4, device=device), window_ops=32,
                    window_ms=1e9, max_pending_ops=64, reject_on_overload=True)
    accepted = 0
    for _ in range(8):  # normal traffic fits the queue bound
        svc.add_points(rng.normal(0, 1, (8, 8)).astype(np.float32))
        accepted += 1
    try:  # a request that can never fit is shed, not queued forever
        svc.add_points(rng.normal(0, 1, (100, 8)).astype(np.float32))
        raise AssertionError("oversized mutation was not shed")
    except Backpressure as e:
        shed = str(e)
    svc.sync()
    print(f"backpressure: {accepted} mutations accepted, oversized one "
          f"shed ('{shed}'); {svc.stats().batches_committed} windows committed")
    return svc.stats()


def async_driver_demo(device="cuda"):
    """The background driver clocks the service: deadlines fire without
    caller traffic and concurrent reads batch into fused gathers."""
    rng = np.random.default_rng(3)
    g = DynamicGraph(emb_dim=8, k=3)
    svc = LPService(StreamEngine(g, delta=1e-4, device=device),
                    window_ops=1000, window_ms=20.0)
    with svc:  # start() the driver; close() on exit drains everything
        t = svc.add_points(rng.normal(0, 1, (12, 8)).astype(np.float32),
                           (np.arange(12) % 2).astype(np.int8))
        # far below window_ops and pump() is never called: only the
        # driver's deadline clock can admit this window
        while not t.committed:
            pass
        tickets = [svc.query_async(rng.integers(0, 12, 16)) for _ in range(32)]
        results = [tk.wait(30.0) for tk in tickets]
        assert all((r.confidence > 0).all() for r in results)
        st = svc.stats()
    print(f"async driver: window deadline-admitted with zero caller traffic "
          f"({st.deadline_admissions} deadline admissions); {st.read_tickets} read "
          f"tickets served by {st.read_batches} fused device gathers")
    return st


def main(device="cuda", vertices=900, batch_size=60):
    estimator_quickstart(device)
    serving_demo(device, vertices, batch_size)
    backpressure_demo(device)
    async_driver_demo(device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
