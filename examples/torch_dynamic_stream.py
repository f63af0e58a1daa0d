"""Insert/delete dynamics and pipelined streaming on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_dynamic_stream.py               # on the GPU
    PYTHONPATH=src python examples/torch_dynamic_stream.py --device cpu

The port of ``examples/dynamic_stream.py``:

1. Deletion semantics through ``StreamEngine``: a hostile cluster flips
   labels in its neighborhood; deleting it restores them, and each batch
   touches only the affected subgraph (watch the frontier sizes).
2. 30 batches through ``submit``/``drain`` (host staging of batch t+1
   overlaps the solve of batch t), with the rung allocations against the
   batch count: the bucket ladder keeps them logarithmic.
3. The backend registry: the same stream through the default backend,
   through ``backend="bsr"`` (the aggregation as a block-sparse product)
   and through the fleet-wide ``REPRO_BACKEND=bsr`` hint, with each
   engine's per-rung decisions and slot budgets.
4. The mesh: the same stream through ``StreamEngine(mesh=DeviceMesh.local(8,
   device))``, eight shards on the one device, beside the single-device
   engine: labels bit-identical, one partition plan per ladder rung.  The
   reference runs this part in a subprocess with 8 virtual devices; the
   port's mesh needs no subprocess.
"""

import argparse
import os
import time

import numpy as np

from repro_torch.core.distributed import DeviceMesh
from repro_torch.core.stream import StreamEngine
from repro_torch.data.synth import StreamSpec, gaussian_mixture_stream
from repro_torch.graph.dynamic import UNLABELED, BatchUpdate, DynamicGraph
from repro_torch.kernels import ops


def deletion_demo(device="cuda"):
    rng = np.random.default_rng(0)
    g = DynamicGraph(emb_dim=4, k=3)
    dyn = StreamEngine(g, delta=1e-5, device=device)

    anchors = np.array([[1, 0, 0, 0], [-1, 0, 0, 0]], np.float32)
    cloud = rng.normal([1, 0, 0, 0], 0.12, (60, 4)).astype(np.float32)
    st = dyn.step(BatchUpdate(
        ins_emb=np.concatenate([anchors, cloud]),
        ins_labels=np.array([1, 0] + [UNLABELED] * 60, np.int8),
        del_ids=np.zeros(0, np.int64)))
    ids = np.flatnonzero(g.alive & (g.labels == UNLABELED))
    print(f"seed: {len(ids)} unlabeled, mean F={g.f[ids].mean():.3f} "
          f"(class 1), frontier={st.frontier_size}, iters={st.iterations}")

    hostile = rng.normal([-0.4, 0, 0, 0], 0.1, (80, 4)).astype(np.float32)
    st = dyn.step(BatchUpdate(ins_emb=hostile, ins_labels=np.full(80, UNLABELED, np.int8),
                              del_ids=np.zeros(0, np.int64)))
    hostile_ids = np.arange(62, 142)
    print(f"hostile wave: mean F(hostile)={g.f[hostile_ids].mean():.3f} "
          f"frontier={st.frontier_size} iters={st.iterations}")

    st = dyn.step(BatchUpdate(ins_emb=np.zeros((0, 4), np.float32),
                              ins_labels=np.zeros(0, np.int8), del_ids=hostile_ids))
    ids = np.flatnonzero(g.alive & (g.labels == UNLABELED))
    print(f"after deletion: mean F={g.f[ids].mean():.3f} "
          f"frontier={st.frontier_size} iters={st.iterations}")
    assert (g.f[ids] > 0.5).all()
    print("labels recovered: deletions propagate only to the affected set\n")
    return float(g.f[ids].min())


def streaming_demo(device="cuda", vertices=1800, batch_size=60):
    spec = StreamSpec(total_vertices=vertices, batch_size=batch_size, seed=0,
                      class_sep=6.0, noise=0.9)
    g = DynamicGraph(emb_dim=spec.emb_dim, k=5)
    eng = StreamEngine(g, delta=1e-4, device=device)
    # per-batch cost = wall time between submit boundaries; pipelined
    # StreamStats.wall_ms windows overlap and would overstate it
    marks = [time.perf_counter()]
    for batch, _ in gaussian_mixture_stream(spec):
        eng.submit(batch)  # stages Δ_t while Δ_{t-1} propagates
        marks.append(time.perf_counter())
    eng.drain()
    eng.close()
    marks.append(time.perf_counter())
    ms = sorted((b - a) * 1e3 for a, b in zip(marks, marks[1:]))
    print(f"pipelined stream: {eng.batches} batches, {eng.recompile_count} rung "
          f"allocations ({len(eng.bucket_keys)} shape buckets), "
          f"median {ms[len(ms) // 2]:.1f} ms/batch\n")
    assert eng.recompile_count <= len(eng.bucket_keys) < eng.batches
    return eng.batches, eng.recompile_count


def backend_demo(device="cuda"):
    """Per-rung backend selection through the kernels.ops registry."""
    spec = StreamSpec(total_vertices=240, batch_size=80, seed=8, class_sep=6.0, noise=0.9)
    batches = [b for b, _ in gaussian_mixture_stream(spec)]

    def drive(tag, backend=None, env=None):
        g = DynamicGraph(emb_dim=spec.emb_dim, k=5)
        old = os.environ.get("REPRO_BACKEND")
        if env is not None:  # the engine reads the hint once, here
            os.environ["REPRO_BACKEND"] = env
        try:
            eng = StreamEngine(g, delta=1e-3, backend=backend, device=device)
        finally:
            if env is not None:
                if old is None:
                    del os.environ["REPRO_BACKEND"]
                else:
                    os.environ["REPRO_BACKEND"] = old
        stats = [eng.step(b) for b in batches]
        s = eng.transport_summary()
        print(f"  {tag}: per-Δ_t backends {[st.backend for st in stats]}")
        print(f"    rung_backends={s['rung_backends']} slot_budgets={s['slot_budgets']} "
              f"bsr_batches={s['bsr_batches']} overflow_fallbacks={s['backend_overflows']}")
        return g.f.copy()

    print(f"backend registry: same stream, two routes (registered: {ops.backend_names()}, "
          f"auto resolves to {ops.select_backend('auto', device=device)} here)")
    f_auto = drive("auto (per-rung registry pick)")
    f_bsr = drive("explicit backend='bsr' (block-sparse product)", backend="bsr")
    f_env = drive("env REPRO_BACKEND=bsr (fleet-wide hint)", env="bsr")
    diff = float(np.abs(f_bsr - f_auto).max())
    print(f"  max |Δf| bsr vs auto: {diff:.2e} (allclose contract; bsr sums edges "
          "in tile order)\n")
    assert diff < 20 * 1e-3  # 20·δ, the reference's bound between its backends
    assert np.array_equal(f_bsr, f_env)  # the hint == the explicit pick
    return diff


def mesh_demo(device="cuda", vertices=1200, batch_size=60):
    """The stream sharded over eight shards of one device, beside the
    single-device engine: the same labels, bit for bit."""
    spec = StreamSpec(total_vertices=vertices, batch_size=batch_size, seed=3, class_sep=6.0,
                      noise=0.9, frac_deleted=0.15, frac_unlabeled=0.84)
    mesh = DeviceMesh.local(8, device=device)
    g_m = DynamicGraph(emb_dim=spec.emb_dim, k=5)
    g_s = DynamicGraph(emb_dim=spec.emb_dim, k=5)
    eng_m = StreamEngine(g_m, delta=1e-4, mesh=mesh)
    eng_s = StreamEngine(g_s, delta=1e-4, device=device)
    for batch, _ in gaussian_mixture_stream(spec):
        eng_m.step(batch)
        eng_s.step(batch)
    assert np.array_equal(g_m.f, g_s.f)
    s = eng_m.transport_summary()
    print(f"{mesh.n_devices}-shard mesh on {mesh.device}: {eng_m.batches} batches, labels "
          f"bit-identical to the single-device engine, {eng_m.plan_builds} partition plans "
          f"for {len(eng_m.bucket_keys)} ladder rungs, rung transports {s['rung_modes']}, "
          f"bytes copied a sweep {s['transport_bytes_per_sweep']}\n")
    return eng_m.plan_builds, len(eng_m.bucket_keys)


def main(device="cuda", vertices=1800, batch_size=60):
    deletion_demo(device)
    streaming_demo(device, vertices, batch_size)
    backend_demo(device)
    mesh_demo(device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
