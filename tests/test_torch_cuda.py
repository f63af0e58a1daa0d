"""The port on the card: the CUDA kernels (frontier sweep, argkmin) against
their plain versions, and the main paths through them.  Every test here needs an NVIDIA GPU and
skips without one; this file imports neither jax nor the reference, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.dynlp import DynLP
from repro_torch.core.stream import StreamEngine
from repro_torch.data.synth import StreamSpec, gaussian_mixture_stream
from repro_torch.graph.dynamic import DynamicGraph
from repro_torch.graph.knn import SELECT_MARGIN, normalize_rows, selection_slack
from repro_torch.kernels.argkmin import argkmin_candidates, argkmin_ref
from repro_torch.kernels.ell_propagate import ell_propagate_ref, ell_propagate_step

pytestmark = pytest.mark.cuda

DELTA = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n,k,nf,row_offset", [
    (90_000, 24, None, 0), (1000, 1, None, 0), (700, 8, 2000, 1300), (700, 8, 1500, 1000),
])
def test_kernel_gives_the_plain_versions_bits(card, n, k, nf, row_offset):
    rng = np.random.default_rng(n + k)
    nf = n if nf is None else nf
    nbr = rng.integers(-1, nf, size=(n, k)).astype(np.int32)
    wgt = (rng.uniform(0.1, 1.0, (n, k)) * (nbr >= 0)).astype(np.float32)
    wl0 = (rng.uniform(0, 1, n) * (rng.random(n) < 0.3)).astype(np.float32)
    wl1 = (rng.uniform(0, 1, n) * (rng.random(n) < 0.3)).astype(np.float32)
    args = [torch.from_numpy(a).to(card) for a in
            (nbr, wgt, wl0, wl1, rng.random(n) < 0.6, rng.uniform(0, 1, nf).astype(np.float32))]
    before = ell_propagate_step.launches
    got_f, got_ch = ell_propagate_step(*args, delta=DELTA, row_offset=row_offset)
    want_f, want_ch = ell_propagate_ref(*args, delta=DELTA, row_offset=row_offset)
    torch.cuda.synchronize()
    assert ell_propagate_step.launches == before + 1
    assert torch.equal(got_f.view(torch.int32), want_f.view(torch.int32))
    assert torch.equal(got_ch, want_ch)


def test_main_path_goes_through_the_kernel(card):
    """A small stream on the card (default device and backend) launches the
    kernel once per sweep and gives the CPU run's labels within 20·δ."""
    spec = StreamSpec(total_vertices=900, batch_size=300, seed=3, class_sep=6.0, noise=0.8)
    gg, gc = DynamicGraph(16, 5), DynamicGraph(16, 5)
    dg, dc = DynLP(gg, delta=DELTA), DynLP(gc, delta=DELTA, device="cpu")
    before = ell_propagate_step.launches
    sweeps = 0
    for batch, _ in gaussian_mixture_stream(spec):
        sweeps += dg.step(batch).iterations
        dc.step(batch)
    assert ell_propagate_step.launches - before == sweeps > 0
    ids = np.flatnonzero(gg.alive & (gg.labels == -1))
    assert np.abs(gg.f[ids] - gc.f[ids]).max() <= 20 * DELTA


def _argkmin_inputs(rng, c, d, m, count, dup=False):
    """A store of capacity ``c`` holding ``count`` rows, the last ``m`` of
    them the batch (made with numpy: dead rows, under-full ``kth``)."""
    emb = np.zeros((c, d), np.float32)
    emb[:count] = normalize_rows(rng.normal(size=(count, d)).astype(np.float32))
    if dup:
        emb[: count // 2] = emb[0]
    valid = np.zeros(c, bool)
    valid[:count] = rng.random(count) > 0.1
    base = count - m
    valid[base:count] = True
    kth = rng.uniform(0.4, 0.9, c).astype(np.float32)
    kth[rng.random(c) < 0.1] = -np.inf
    bvalid = np.arange(m) < m - m // 5  # the tail rows are padding
    return [torch.from_numpy(a) for a in (emb, valid, kth, emb[base:count].copy(), bvalid)], base


@pytest.mark.parametrize("c,d,m,count,k,dup", [
    (131072, 16, 8192, 103192, 5, False),  # the main path's width
    (3000, 40, 100, 2900, 5, True),  # ragged C and M, mass duplicates
    (700, 128, 37, 650, 8, False),  # D = 128, TK = 16
    (5000, 24, 300, 4900, 24, True),  # TK = 32: the long list
])
def test_argkmin_kernel_gives_the_plain_versions_bits(card, c, d, m, count, k, dup):
    args, base = _argkmin_inputs(np.random.default_rng(c + d), c, d, m, count, dup)
    args = [a.to(card) for a in args]
    slack = selection_slack(d)
    before = argkmin_candidates.launches
    got = argkmin_candidates(*args, base, slack, k=k)
    want = argkmin_ref(*args, base, slack, topk=min(k + SELECT_MARGIN, c))
    torch.cuda.synchronize()
    assert argkmin_candidates.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_device_ingest_stream_goes_through_argkmin(card):
    """``StreamEngine(ingest="device")`` on the card launches argkmin once
    per batch with insertions, and its graph equals a CPU host-ingest
    DynLP's byte for byte (labels within 20·δ)."""
    spec = StreamSpec(total_vertices=900, batch_size=300, seed=3, class_sep=6.0, noise=0.8)
    gg, gc = DynamicGraph(16, 5), DynamicGraph(16, 5)
    eng = StreamEngine(gg, delta=DELTA, ingest="device")
    dc = DynLP(gc, delta=DELTA, device="cpu")
    before = argkmin_candidates.launches
    inserts = 0
    for batch, _ in gaussian_mixture_stream(spec):
        inserts += len(batch.ins_emb) > 0
        assert eng.step(batch).backend == "ell_cuda"
        dc.step(batch)
    assert argkmin_candidates.launches - before == inserts > 0
    for name in ("src", "dst", "wgt", "knn_idx", "knn_wgt"):
        assert getattr(gg, name).tobytes() == getattr(gc, name).tobytes(), name
    ids = np.flatnonzero(gg.alive & (gg.labels == -1))
    assert np.abs(gg.f[ids] - gc.f[ids]).max() <= 20 * DELTA
