"""The port's baselines: ``ITLP`` (and ``propagate_full_ell``) and ``STLP``
(``problem_to_dense``, ``harmonic_solve``, ``_neumann_solve``).

Mirrors the ITLP/STLP tests of ``tests/test_dynlp.py`` against the port's
classes, then holds the port to the JAX package on the same inputs.
Tolerances:

- ITLP: the graph's bytes equal; F within 20·δ (the reference's bound
  between its own backends); iterations equal on the streams tested.  (XLA
  and the port sum the K lanes in different orders, so a stream whose
  largest last step sat within an ULP of δ could stop one sweep apart;
  none of these does.)
- ``propagate_full_ell`` on CPU tensors gives ``propagate_full``'s bits and
  iteration count (the kernel's plain version is the same arithmetic).
- ``problem_to_dense``: equal bits (no (row, col) pair repeats in an ELL
  row, so each entry is one weight in both packages).
- ``harmonic_solve``: within 1e-4 (two LU solves of the same fp32 system),
  predictions equal where |F − 0.5| > 1e-3.
- ``_neumann_solve``: within 1e-5 (the same dense products in fp32).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.itlp import ITLP as JaxITLP
from repro.core.snapshot import build_problem as jax_build_problem
from repro.core.stlp import STLP as JaxSTLP
from repro.data import synth as jsynth
from repro.graph import dynamic as jdyn
from repro_torch.core import stlp
from repro_torch.core.dynlp import DynLP
from repro_torch.core.itlp import ITLP
from repro_torch.core.propagate import propagate_full
from repro_torch.core.snapshot import build_problem
from repro_torch.core.stlp import STLP, harmonic_solve
from repro_torch.data.synth import StreamSpec, accuracy, gaussian_mixture_stream
from repro_torch.graph.dynamic import UNLABELED, BatchUpdate, DynamicGraph
from repro_torch.kernels import ops
from repro_torch.state import problem_from_arrays

from helpers import random_problem

jstlp = importlib.import_module("repro.core.stlp")

torch.set_num_threads(1)

DELTA = 1e-4
F_TOL = 20 * DELTA
GRAPH = ("src", "dst", "wgt", "knn_idx", "knn_wgt", "alive", "labels")
SPEC = StreamSpec(total_vertices=1200, batch_size=400, seed=3, class_sep=6.0, noise=0.8)


def _run_stream(engine_cls, spec=SPEC, **kw):
    g = DynamicGraph(emb_dim=spec.emb_dim, k=5)
    eng = engine_cls(g, device="cpu", **kw)
    truth = {}
    stats = []
    for batch, cls in gaussian_mixture_stream(spec):
        base = g.num_nodes
        stats.append(eng.step(batch))
        for i, c in enumerate(cls):
            truth[base + i] = c
    ids = np.flatnonzero(g.alive & (g.labels == UNLABELED))
    pred = (g.f[ids] >= 0.5).astype(np.int8)
    tr = np.array([truth[i] for i in ids])
    return g, ids, pred, tr, stats


# --------------------------------------------------------------------- #
# test_dynlp.py's baseline tests, against the port's classes
# --------------------------------------------------------------------- #
def test_dynlp_tracks_harmonic_solution():
    g, ids, pred, truth, stats = _run_stream(DynLP, delta=1e-4)
    assert all(s.converged for s in stats)
    snap = build_problem(g, device="cpu")
    fh = harmonic_solve(snap.problem).numpy()[: len(snap.unl_ids)]
    pred_h = (fh >= 0.5).astype(np.int8)
    assert accuracy(pred, pred_h) > 0.98  # paper: ~99% vs harmonic optimum
    assert np.abs(g.f[snap.unl_ids] - fh).mean() < 0.05


def test_dynlp_fewer_iterations_than_itlp():
    _, _, pred_d, truth, st_d = _run_stream(DynLP, delta=1e-4)
    _, _, pred_i, _, st_i = _run_stream(ITLP, delta=1e-4)
    # paper Fig. 7: DynLP needs fewer iterations in every experiment
    assert sum(s.iterations for s in st_d) < sum(s.iterations for s in st_i)
    assert accuracy(pred_d, truth) == pytest.approx(accuracy(pred_i, truth), abs=0.05)


def test_stlp_matches_dynlp_small():
    spec = StreamSpec(total_vertices=600, batch_size=300, seed=7, class_sep=6.0, noise=0.8)
    _, _, pred_d, _, _ = _run_stream(DynLP, spec, delta=1e-5)
    _, _, pred_s, _, _ = _run_stream(STLP, spec)
    assert accuracy(pred_d, pred_s) > 0.98


def _guard_batch():
    emb = np.random.default_rng(0).normal(0, 1, (40, 4)).astype(np.float32)
    labels = np.full(40, UNLABELED, np.int8)
    labels[:2] = [0, 1]
    return BatchUpdate(ins_emb=emb, ins_labels=labels, del_ids=np.zeros(0, np.int64))


def test_stlp_memory_guard():
    eng = STLP(DynamicGraph(emb_dim=4, k=3), max_unlabeled=10, device="cpu")
    with pytest.raises(MemoryError, match="STLP dense solve needs 38"):
        eng.step(_guard_batch())


@pytest.mark.parametrize("cap", [37, 38])
def test_stlp_memory_guard_at_the_references_row_count(cap):
    """Both packages raise for a cap one below the unlabeled count (38)
    and solve at the count itself, with the same message."""
    tb, jb = _guard_batch(), _guard_batch()
    teng = STLP(DynamicGraph(emb_dim=4, k=3), max_unlabeled=cap, device="cpu")
    jeng = JaxSTLP(jdyn.DynamicGraph(emb_dim=4, k=3), max_unlabeled=cap)
    if cap < 38:
        with pytest.raises(MemoryError) as te:
            teng.step(tb)
        with pytest.raises(MemoryError) as je:
            jeng.step(jb)
        assert str(te.value) == str(je.value)
    else:
        ts, js = teng.step(tb), jeng.step(jb)
        assert (ts.num_unlabeled, ts.dense_bytes) == (js.num_unlabeled, js.dense_bytes)


def test_stlp_gamma_accuracy_ordering():
    """Smaller γ (more Neumann terms) approximates the exact harmonic
    solution at least as well as larger γ (paper Table 4 trend)."""
    spec = StreamSpec(total_vertices=500, batch_size=500, seed=11, class_sep=5.0, noise=1.0)
    errs = {}
    for gamma in (None, 1.0, 10.0):
        g, ids, _, _, _ = _run_stream(STLP, spec, gamma=gamma)
        if gamma is None:
            f_exact = g.f[ids].copy()
        errs[gamma] = np.abs(g.f[ids] - f_exact).mean()
    assert errs[1.0] <= errs[10.0] + 1e-6
    assert errs[None] == 0.0


# --------------------------------------------------------------------- #
# ITLP and propagate_full_ell
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed,n,pad,max_iters", [
    (0, 60, 0, 100_000), (1, 300, 37, 100_000), (2, 500, 12, 7), (3, 80, 5, 0),
])
def test_propagate_full_ell_gives_propagate_fulls_bits(seed, n, pad, max_iters):
    """On CPU tensors the sweep's plain version runs: F's bits, the
    iteration count, ``converged`` and the residual equal
    ``propagate_full``'s, padding rows included (they stay at f0)."""
    jp = random_problem(np.random.default_rng(seed), n, 3)
    arrays = [np.asarray(a) for a in jp]
    if pad:
        arrays = [np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
                  for a, fill in zip(arrays, (-1, 0.0, 0.0, 0.0, False))]
    p = problem_from_arrays(*arrays, device="cpu")
    f0 = torch.full((n + pad,), 0.5)
    got = ops.propagate_full_ell(p, f0, delta=DELTA, max_iters=max_iters)
    want = propagate_full(p, f0, delta=DELTA, max_iters=max_iters)
    assert got.f.view(torch.int32).equal(want.f.view(torch.int32))
    assert (got.iterations, got.converged, got.max_residual) == \
        (want.iterations, want.converged, want.max_residual)
    assert got.f[n:].eq(0.5).all()


@pytest.mark.parametrize("spec_kw", [
    dict(total_vertices=900, batch_size=300, seed=5, class_sep=6.0, noise=0.9),
    dict(total_vertices=800, batch_size=200, seed=9, class_sep=5.0, noise=1.0,
         frac_deleted=0.2, frac_labeled=0.05),
])
def test_itlp_matches_reference(spec_kw):
    """The port's ITLP.step against the reference's on the same stream:
    graph bytes equal, F within 20·δ, iterations equal."""
    tg, jg = DynamicGraph(emb_dim=16, k=5), jdyn.DynamicGraph(emb_dim=16, k=5)
    te, je = ITLP(tg, delta=DELTA, device="cpu"), JaxITLP(jg, delta=DELTA)
    for (tb, _), (jb, _) in zip(gaussian_mixture_stream(StreamSpec(**spec_kw)),
                                jsynth.gaussian_mixture_stream(jsynth.StreamSpec(**spec_kw))):
        ts, js = te.step(tb), je.step(jb)
        for name in GRAPH:
            assert getattr(tg, name).tobytes() == getattr(jg, name).tobytes(), name
        assert ts.converged and js.converged and ts.num_unlabeled == js.num_unlabeled
        assert ts.iterations == js.iterations
        ids = np.flatnonzero(tg.alive & (tg.labels == UNLABELED))
        assert np.abs(tg.f[ids] - jg.f[ids]).max() <= F_TOL


# --------------------------------------------------------------------- #
# STLP's solves against the reference's
# --------------------------------------------------------------------- #
def _graph_problem(seed, vertices=600, batch_size=300):
    """A bucketed problem of a reference graph, both packages' forms."""
    spec = jsynth.StreamSpec(total_vertices=vertices, batch_size=batch_size, seed=seed,
                             class_sep=5.0, noise=1.0)
    g = jdyn.DynamicGraph(emb_dim=spec.emb_dim, k=5)
    for batch, _ in jsynth.gaussian_mixture_stream(spec):
        g.apply_batch(batch)
    jp = jax_build_problem(g, auto_bucket=True).problem
    return jp, problem_from_arrays(*(np.asarray(a) for a in jp), device="cpu")


@pytest.mark.parametrize("seed", [1, 2])
def test_problem_to_dense_matches_reference(seed):
    jp, tp = _graph_problem(seed)
    nbr = tp.nbr.numpy()
    rows = np.repeat(np.arange(len(nbr)), nbr.shape[1])[nbr.ravel() >= 0]
    pairs = rows * len(nbr) + nbr.ravel()[nbr.ravel() >= 0]
    assert len(np.unique(pairs)) == len(pairs)  # no (row, col) repeats
    got = stlp.problem_to_dense(tp).numpy()
    assert got.tobytes() == np.asarray(jstlp.problem_to_dense(jp)).tobytes()


@pytest.mark.parametrize("seed,vertices", [(1, 600), (4, 1000)])
def test_harmonic_solve_matches_reference(seed, vertices):
    jp, tp = _graph_problem(seed, vertices)
    got = harmonic_solve(tp).numpy()
    want = np.asarray(jstlp.harmonic_solve(jp))
    assert np.abs(got - want).max() <= 1e-4
    far = np.abs(want - 0.5) > 1e-3
    assert np.array_equal(got[far] >= 0.5, want[far] >= 0.5)
    assert got[~tp.valid.numpy()].tolist() == [0.5] * int((~tp.valid).sum())


@pytest.mark.parametrize("gamma", [0.5, 1.0, 2.0])
def test_neumann_solve_matches_reference(gamma):
    jp, tp = _graph_problem(3)
    t = max(1, int(np.ceil(10.0 / gamma)))
    got = stlp._neumann_solve(tp, t).numpy()
    want = np.asarray(jstlp._neumann_solve(jp, jnp.int32(t)))
    assert np.abs(got - want).max() <= 1e-5


def test_stlp_step_matches_reference():
    spec_kw = dict(total_vertices=600, batch_size=300, seed=7, class_sep=6.0, noise=0.8)
    for gamma in (None, 1.0):
        tg, jg = DynamicGraph(emb_dim=16, k=5), jdyn.DynamicGraph(emb_dim=16, k=5)
        te, je = STLP(tg, gamma=gamma, device="cpu"), JaxSTLP(jg, gamma=gamma)
        for (tb, _), (jb, _) in zip(
                gaussian_mixture_stream(StreamSpec(**spec_kw)),
                jsynth.gaussian_mixture_stream(jsynth.StreamSpec(**spec_kw))):
            ts, js = te.step(tb), je.step(jb)
            assert (ts.num_unlabeled, ts.dense_bytes) == (js.num_unlabeled, js.dense_bytes)
            ids = np.flatnonzero(tg.alive & (tg.labels == UNLABELED))
            assert np.abs(tg.f[ids] - jg.f[ids]).max() <= 1e-4


def test_baselines_run_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    for cls in (ITLP, STLP):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(DynamicGraph(emb_dim=4, k=3))
