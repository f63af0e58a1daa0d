"""Hooks on the program's layer boundaries, shared by the metric readers.

Each wraps one call into a layer of ``repro_torch`` (``PERF.md`` §3):

* ``SELECT``: ``DeviceIngestor.select``, device ingest (store append, the
  argkmin kernel, the D2H copies of its lists); it captures the call's
  argkmin shape ``(m, c_valid, c, d, topk)``;
* ``APPLY_BATCH``: ``DynamicGraph.apply_batch``, the graph update (the
  select, then the canonical lists, merges and the edge refresh);
* ``SUBMIT``: ``StreamEngine.submit``, the engine (the graph update, then
  the snapshot, G' components, supernode init and the solve's queueing);
* ``SOLVE``: ``kernels.ops.run_propagation`` as the engine's worker thread
  calls it, the frontier loop;
* ``DRAIN``: ``StreamEngine.drain``; it captures each commit's sweeps
  (``StreamStats.iterations``);
* ``SWEEP``: ``kernels.ops.ell_propagate_step`` as the frontier loop calls
  it, not timed; it captures the sweep's ``(n, k, nf)`` and its frontier's
  row count as a device scalar (read after the window).
"""

from __future__ import annotations

from portbench.spans import Hook


def _select_shape(args, kwargs, res):
    ingestor, _graph, new_ids = args[0], args[1], args[2]
    s = ingestor.store
    return dict(m=len(new_ids), c_valid=int(s.valid.sum()), c=s.capacity, d=s.dp,
                topk=int(res.cand_idx.shape[1]))


def _sweeps(args, kwargs, res):
    return None if res is None else res.iterations


def _sweep_rows(args, kwargs, res):
    nbr, frontier, f = args[0], args[4], args[5]
    return dict(n=nbr.shape[0], k=nbr.shape[1], nf=f.shape[0], rows=frontier.sum())


SELECT = Hook("repro_torch.ingest.incremental_knn:DeviceIngestor.select", "ingest.select",
              capture=_select_shape)
APPLY_BATCH = Hook("repro_torch.graph.dynamic:DynamicGraph.apply_batch", "graph.apply_batch")
SUBMIT = Hook("repro_torch.core.stream:StreamEngine.submit", "engine.submit")
SOLVE = Hook("repro_torch.kernels.ops:run_propagation", "solve.run")
DRAIN = Hook("repro_torch.core.stream:StreamEngine.drain", "engine.drain", capture=_sweeps)
SWEEP = Hook("repro_torch.kernels.ops:ell_propagate_step", "solve.sweep", capture=_sweep_rows,
             timed=False)
