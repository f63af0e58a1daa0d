"""Port vs reference, the slice as a whole: ``DynLP.step`` over a stream.

Per step, the counts that come from host state or exact integers
(components, frontier size, unlabeled count) must be equal; the labels
within 20·δ (the packages sum in different orders; the reference holds its
own backends to the same bound) and the hard predictions equal wherever a
label is further than that from the cutoff; sweep counts within 5%.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.dynlp import DynLP as JaxDynLP
from repro.data import synth as jsynth
from repro.graph import dynamic as jdyn
from repro_torch.core.dynlp import DynLP
from repro_torch.data import synth as tsynth
from repro_torch.graph import dynamic as tdyn
from repro_torch.state import graph_from_reference

torch.set_num_threads(1)

DELTA = 1e-4
F_TOL = 20 * DELTA
SPEC = dict(total_vertices=900, batch_size=300, seed=3, class_sep=6.0, noise=0.8)
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _check_labels(jg, tg):
    ids = np.flatnonzero(tg.alive & (tg.labels == -1))
    np.testing.assert_array_equal(ids, np.flatnonzero(jg.alive & (jg.labels == -1)))
    diff = np.abs(jg.f[ids] - tg.f[ids])
    assert diff.max(initial=0) <= F_TOL, diff.max()
    far = np.abs(jg.f[ids] - 0.5) > F_TOL
    np.testing.assert_array_equal(jg.f[ids][far] >= 0.5, tg.f[ids][far] >= 0.5)


def _check_stats(js, ts):
    assert (ts.num_components, ts.frontier_size, ts.num_unlabeled) == \
        (js.num_components, js.frontier_size, js.num_unlabeled)
    assert abs(ts.iterations - js.iterations) <= max(1, 0.05 * js.iterations)
    assert ts.converged and js.converged


@pytest.mark.parametrize("backend", ["ref", "ell_cuda"])
def test_stream_matches_reference(backend):
    jg, tg = jdyn.DynamicGraph(16, 5), tdyn.DynamicGraph(16, 5)
    jd = JaxDynLP(jg, delta=DELTA, backend="ref")
    td = DynLP(tg, delta=DELTA, backend=backend, device="cpu")
    for (jb, _), (tb, _) in zip(jsynth.gaussian_mixture_stream(jsynth.StreamSpec(**SPEC)),
                                tsynth.gaussian_mixture_stream(tsynth.StreamSpec(**SPEC))):
        _check_stats(jd.step(jb), td.step(tb))
        _check_labels(jg, tg)
    ids_j, pred_j = jd.predictions()
    ids_t, pred_t = td.predictions()
    np.testing.assert_array_equal(ids_j, ids_t)
    assert (pred_j == pred_t).mean() > 0.99


def test_backends_agree_bitwise_over_a_stream():
    """Inside the port the ref engine and the kernel loop (its plain
    version here) give the same bits and sweep counts at every step."""
    ga, gb = tdyn.DynamicGraph(16, 5), tdyn.DynamicGraph(16, 5)
    da = DynLP(ga, delta=DELTA, backend="ref", device="cpu")
    db = DynLP(gb, delta=DELTA, backend="ell_cuda", device="cpu")
    for batch, _ in tsynth.gaussian_mixture_stream(tsynth.StreamSpec(**SPEC)):
        sa, sb = da.step(batch), db.step(batch)
        assert (sa.iterations, sa.num_components) == (sb.iterations, sb.num_components)
        assert ga.f.tobytes() == gb.f.tobytes()


def test_hand_off_from_reference_mid_stream():
    """Two batches in JAX, the state carried into the port, then both
    packages continue on the same batches."""
    spec = dict(SPEC, total_vertices=1200)
    jg = jdyn.DynamicGraph(16, 5)
    jd = JaxDynLP(jg, delta=DELTA, backend="ref")
    jbatches = list(jsynth.gaussian_mixture_stream(jsynth.StreamSpec(**spec)))
    tbatches = list(tsynth.gaussian_mixture_stream(tsynth.StreamSpec(**spec)))
    for jb, _ in jbatches[:2]:
        jd.step(jb)
    tg = graph_from_reference(jg.state_arrays(), emb_dim=16, k=5)
    td = DynLP(tg, delta=DELTA, device="cpu")
    for (jb, _), (tb, _) in zip(jbatches[2:], tbatches[2:]):
        _check_stats(jd.step(jb), td.step(tb))
        _check_labels(jg, tg)
        assert jg.src.tobytes() == tg.src.tobytes()


def test_deletions_remove_influence():
    """Insert a hostile cluster, then delete it: labels recover (mirrors the
    reference's test on the port)."""
    rng = np.random.default_rng(0)
    g = tdyn.DynamicGraph(emb_dim=4, k=3)
    dyn = DynLP(g, delta=1e-5, device="cpu")
    emb0 = np.array([[1, 0, 0, 0], [-1, 0, 0, 0]], np.float32)
    cloud = rng.normal([1, 0, 0, 0], 0.1, (20, 4)).astype(np.float32)
    none = np.zeros(0, np.int64)
    dyn.step(tdyn.BatchUpdate(ins_emb=np.concatenate([emb0, cloud]),
                              ins_labels=np.array([1, 0] + [-1] * 20, np.int8),
                              del_ids=none))
    ids = np.flatnonzero(g.alive & (g.labels == -1))
    assert (g.f[ids] > 0.5).all()
    hostile = rng.normal([-1, 0, 0, 0], 0.1, (30, 4)).astype(np.float32)
    dyn.step(tdyn.BatchUpdate(ins_emb=hostile, ins_labels=np.full(30, -1, np.int8),
                              del_ids=none))
    hostile_ids = np.arange(22, 52)
    assert (g.f[hostile_ids] < 0.5).all()
    dyn.step(tdyn.BatchUpdate(ins_emb=np.zeros((0, 4), np.float32),
                              ins_labels=np.zeros(0, np.int8), del_ids=hostile_ids))
    ids = np.flatnonzero(g.alive & (g.labels == -1))
    assert (g.f[ids] > 0.5).all() and not g.alive[hostile_ids].any()


def test_constructor_defaults_and_validation():
    d = DynLP(tdyn.DynamicGraph(8, 5), device="cpu")
    assert (d.max_k, d.auto_bucket, d.backend, d.delta) == (20, True, None, 1e-4)
    assert DynLP(tdyn.DynamicGraph(8, 5), max_k=None, device="cpu").max_k is None
    with pytest.raises(ValueError, match="max_k"):
        DynLP(tdyn.DynamicGraph(8, 5), max_k="huge", device="cpu")


def test_no_device_means_cuda():
    """Without a CUDA device, leaving ``device`` out raises rather than
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    from repro_torch.core.snapshot import build_problem

    g = tdyn.DynamicGraph(8, 5)
    for call in (lambda: DynLP(g), lambda: build_problem(g)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_port_imports_neither_jax_nor_reference():
    """Importing every module of the port leaves jax and repro unloaded."""
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib'))\n"
        "             or k == 'repro' or k.startswith('repro.'))\n"
        "assert len(mods) >= 15, mods\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
