"""The port's ``bsr`` backend against the JAX package's, on the CPU.

Mirrors ``tests/test_kernels.py`` (the BSR layout, tile fill and SpMV) and
``tests/test_stream_bsr.py`` (the engine).  The JAX side runs its Pallas
kernel in interpret mode, as its own tests do.  Tolerances:

  * the host layout, the tile fill and the staged host state of each batch
    are byte-identical (the same numpy and the same scatter targets);
  * one SpMV within 1e-5 in float32 and 2e-2 in bfloat16 (the reference's
    own bounds: the TPU kernel's dot and the port's column-order sum round
    differently);
  * a one-shot solve within 20·δ, and a stream within ``BSR_ATOL`` = 2e-3,
    the bound the reference holds its own ``bsr`` engine to.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import snapshot as jsnap
from repro.core.components import component_order as j_component_order
from repro.core.stream import StreamEngine as JaxStreamEngine
from repro.data import synth as jsynth
from repro.graph import dynamic as jdyn
from repro.kernels import bsr_spmv as jbsr
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import snapshot as tsnap
from repro_torch.core.components import component_order
from repro_torch.core.dynlp import DynLP
from repro_torch.core.propagate import bsr_update_island
from repro_torch.core.stream import StreamEngine
from repro_torch.data import synth as tsynth
from repro_torch.graph.dynamic import UNLABELED, BatchUpdate, DynamicGraph
from repro_torch.kernels import ops
from repro_torch.kernels.bsr_spmv import (bsr_spmv, bsr_spmv_ref, dense_to_bsr,
                                          ell_bsr_layout, fill_bsr_blocks)
from repro_torch.state import bsr_layout_from_reference, problem_from_arrays

from helpers import random_problem

torch.set_num_threads(1)

DELTA = 1e-4
BSR_ATOL = 2e-3
EMB_DIM = 8
NONE = np.zeros(0, np.int64)


def _random_ell(rng, n, k):
    """Random ELL adjacency with per-row-distinct neighbors (the reference
    test's generator: the shape snapshot builds guarantee)."""
    nbr = np.full((n, k), -1, np.int32)
    wgt = np.zeros((n, k), np.float32)
    for i in range(n):
        deg = int(rng.integers(0, k + 1))
        cols = rng.choice(n, size=deg, replace=False)
        nbr[i, :deg] = cols
        wgt[i, :deg] = rng.uniform(0.1, 1.0, deg)
    return nbr, wgt


def _pair(seed, n, avg_deg=4.0):
    """The same random problem for both packages."""
    jp = random_problem(np.random.default_rng(seed), n, 2, avg_deg)
    return jp, problem_from_arrays(*(np.asarray(a) for a in jp), device="cpu")


def _assert_layouts_equal(got, want):
    assert got.slot.tobytes() == np.asarray(want.slot).tobytes()
    assert got.slot.dtype == np.int32
    assert (got.num_slots, got.n_blocks, got.nnz, got.block_size) == \
        (want.num_slots, want.n_blocks, want.nnz, want.block_size)
    assert got.fill == want.fill


def _fill_both(nbr, wgt, slot, bs, num_slots):
    tb, tc = fill_bsr_blocks(torch.from_numpy(nbr), torch.from_numpy(wgt),
                             torch.from_numpy(np.asarray(slot)), block_size=bs,
                             num_slots=num_slots)
    jb, jc = jbsr.fill_bsr_blocks(jnp.asarray(nbr), jnp.asarray(wgt), jnp.asarray(slot),
                                  block_size=bs, num_slots=num_slots)
    return (tb, tc), (np.asarray(jb), np.asarray(jc))


# --------------------------------------------------------------------- #
# host layout and device tile fill
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n,k,bs", [(64, 4, 8), (128, 7, 16), (96, 3, 8)])
def test_layout_matches_reference(n, k, bs):
    nbr, _ = _random_ell(np.random.default_rng(n + k + bs), n, k)
    _assert_layouts_equal(ell_bsr_layout(nbr, bs), jbsr.ell_bsr_layout(nbr, bs))


def test_layout_empty_and_non_multiple():
    empty = np.full((16, 2), -1, np.int32)
    got = ell_bsr_layout(empty, 8)
    _assert_layouts_equal(got, jbsr.ell_bsr_layout(empty, 8))
    assert got.nnz == 0 and got.num_slots == 1 and got.fill == 0.0 and (got.slot == -1).all()
    with pytest.raises(ValueError, match="multiple of block_size"):
        ell_bsr_layout(np.full((10, 2), -1, np.int32), 8)
    with pytest.raises(ValueError, match="multiple of block_size"):
        jbsr.ell_bsr_layout(np.full((10, 2), -1, np.int32), 8)


def _stream_graphs(n_batches=3, seed=4):
    """The same stream through a reference graph and a port graph."""
    spec = dict(total_vertices=60 * n_batches, batch_size=60, emb_dim=EMB_DIM, seed=seed,
                class_sep=6.0, noise=0.9)
    jg, tg = jdyn.DynamicGraph(EMB_DIM, k=5), DynamicGraph(EMB_DIM, k=5)
    for (jb, _), (tb, _) in zip(jsynth.gaussian_mixture_stream(jsynth.StreamSpec(**spec)),
                                tsynth.gaussian_mixture_stream(tsynth.StreamSpec(**spec))):
        jg.apply_batch(jb)
        tg.apply_batch(tb)
    return jg, tg


def test_layout_and_reorder_of_a_real_snapshot_match_reference():
    """A host snapshot of a kNN stream, padded to the tile edge: the
    component order, the reordered snapshot and its layout are the same
    bytes in both packages."""
    jg, tg = _stream_graphs()
    jh = jsnap.build_host_problem(jg, auto_bucket=True, row_multiple=8, max_k=20)
    th = tsnap.build_host_problem(tg, auto_bucket=True, row_multiple=8, max_k=20)
    assert th.nbr.tobytes() == jh.nbr.tobytes()
    order = component_order(th.nbr)
    assert order.tobytes() == j_component_order(jh.nbr).tobytes()
    ts, tinv = tsnap.reorder_host_snapshot(th, order)
    js, jinv = jsnap.reorder_host_snapshot(jh, order)
    assert tinv.tobytes() == jinv.tobytes()
    for name in ("nbr", "wgt", "wl0", "wl1", "valid", "unl_ids", "remap"):
        assert getattr(ts, name).tobytes() == np.asarray(getattr(js, name)).tobytes(), name
    got, want = ell_bsr_layout(ts.nbr, 8), jbsr.ell_bsr_layout(js.nbr, 8)
    _assert_layouts_equal(got, want)
    assert got.nnz > 0 and 0 < got.fill <= 1
    with pytest.raises(ValueError, match="order has"):
        tsnap.reorder_host_snapshot(th, order[:-1])


@pytest.mark.parametrize("n,k,bs,extra", [
    (64, 4, 8, 2),  # a padded budget
    (128, 7, 16, 0),  # the exact requirement
    (96, 3, 8, -1),  # one slot short: the lanes past the budget are dropped
    (64, 5, 8, -2),
])
def test_fill_matches_reference_bit_for_bit(n, k, bs, extra):
    rng = np.random.default_rng(n * k + bs)
    nbr, wgt = _random_ell(rng, n, k)
    layout = ell_bsr_layout(nbr, bs)
    num_slots = layout.num_slots + extra
    assert num_slots >= 1
    (tb, tc), (jb, jc) = _fill_both(nbr, wgt, layout.slot, bs, num_slots)
    assert tb.shape == (n // bs, num_slots, bs, bs) and tc.shape == (n // bs, num_slots)
    assert (tb.dtype, tc.dtype) == (torch.float32, torch.int32)
    assert tb.numpy().tobytes() == jb.tobytes()
    assert tc.numpy().tobytes() == jc.tobytes()
    if extra < 0:  # the dropped lanes lost their weight, nothing moved rows
        assert float(tb.sum()) < float(wgt.sum())
        kept = (layout.slot >= 0) & (layout.slot < num_slots)
        assert np.isclose(float(tb.double().sum()), float(wgt[kept].astype(np.float64).sum()))


@pytest.mark.parametrize("n,k,bs", [(64, 4, 8), (128, 7, 16), (96, 3, 8)])
def test_fill_describes_the_dense_matrix(n, k, bs):
    """The ELL → BSR build describes the same matrix as the dense oracle:
    the same per-row block-column sets, and the SpMV equals ``dense @ x``."""
    rng = np.random.default_rng(n + k + bs)
    nbr, wgt = _random_ell(rng, n, k)
    layout = ell_bsr_layout(nbr, bs)
    blocks, cols = fill_bsr_blocks(torch.from_numpy(nbr), torch.from_numpy(wgt),
                                   torch.from_numpy(layout.slot), block_size=bs,
                                   num_slots=layout.num_slots + 2)
    dense = np.zeros((n, n), np.float32)
    rows = np.repeat(np.arange(n), k)
    c = nbr.reshape(-1)
    keep = c >= 0
    dense[rows[keep], c[keep]] = wgt.reshape(-1)[keep]
    blocks_o, cols_o = dense_to_bsr(dense, bs)
    for i in range(n // bs):
        assert {int(v) for v in cols[i] if v >= 0} == {int(v) for v in cols_o[i] if v >= 0}
    x = rng.normal(0, 1, n).astype(np.float32)
    got = bsr_spmv(blocks, cols, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, dense @ x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, bsr_spmv(torch.from_numpy(blocks_o), torch.from_numpy(cols_o),
                      torch.from_numpy(x)).numpy(), rtol=1e-5, atol=1e-5)


def test_reference_layout_handed_over_fills_the_same_tiles():
    """A reference ``BsrLayout`` carried into the port (``state.py``) gives
    the same ``fill_bsr_blocks`` output in both packages."""
    rng = np.random.default_rng(11)
    nbr, wgt = _random_ell(rng, 80, 6)
    jl = jbsr.ell_bsr_layout(nbr, 8)
    tl = bsr_layout_from_reference(jl.slot, jl.num_slots, jl.n_blocks, jl.nnz, jl.block_size)
    _assert_layouts_equal(tl, jl)
    (tb, tc), (jb, jc) = _fill_both(nbr, wgt, tl.slot, 8, tl.num_slots)
    assert tb.numpy().tobytes() == jb.tobytes() and tc.numpy().tobytes() == jc.tobytes()


# --------------------------------------------------------------------- #
# the SpMV
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n,bs,density,dtype", [
    (64, 8, 0.3, "float32"), (128, 16, 0.1, "float32"),
    (64, 8, 0.5, "bfloat16"), (256, 32, 0.05, "float32"),
])
def test_spmv_matches_reference_and_dense(n, bs, density, dtype):
    rng = np.random.default_rng(int(n * bs * density))
    mask = rng.random((n // bs, n // bs)) < density
    a = rng.normal(0, 1, (n, n)).astype(np.float32)
    a *= np.kron(mask, np.ones((bs, bs), np.float32))
    x = rng.normal(0, 1, n).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jblocks, jcols = jbsr.dense_to_bsr(jnp.asarray(a, jdt), bs)
    blocks, cols = dense_to_bsr(a, bs)
    assert cols.tobytes() == np.asarray(jcols).tobytes()
    tblocks = torch.from_numpy(blocks).to(tdt)
    assert tblocks.float().numpy().tobytes() == np.asarray(jblocks, np.float32).tobytes()
    got = bsr_spmv_ref(tblocks, torch.from_numpy(cols), torch.from_numpy(x).to(tdt)).numpy()
    tol = 1e-5 if dtype == "float32" else 2e-2
    for want in (jbsr.bsr_spmv(jblocks, jcols, jnp.asarray(x, jdt)),
                 jref.bsr_spmv_ref(jblocks, jcols, jnp.asarray(x, jdt))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)
    dense = tblocks.float().numpy()  # the tiles as the kernel reads them
    a_eff = np.zeros_like(a)
    for i in range(n // bs):
        for j, c in enumerate(cols[i]):
            if c >= 0:
                a_eff[i * bs:(i + 1) * bs, c * bs:(c + 1) * bs] = dense[i, j]
    xw = torch.from_numpy(x).to(tdt).float().numpy()
    np.testing.assert_allclose(got, a_eff.astype(np.float64) @ xw, rtol=tol, atol=tol)


def test_spmv_wrapper_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(5)
    blocks, cols = dense_to_bsr(rng.normal(0, 1, (32, 48)).astype(np.float32), 8)
    x = torch.from_numpy(rng.normal(0, 1, 48).astype(np.float32))
    before = bsr_spmv.launches
    got = bsr_spmv(torch.from_numpy(blocks), torch.from_numpy(cols), x)
    assert bsr_spmv.launches == before  # a launch is counted on the card only
    want = bsr_spmv_ref(torch.from_numpy(blocks), torch.from_numpy(cols), x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # every slot empty, and no column blocks at all
    none = torch.full((4, 3), -1, dtype=torch.int32)
    zeros = torch.zeros((4, 3, 8, 8))
    assert torch.equal(bsr_spmv(zeros, none, torch.ones(16)), torch.zeros(32))
    assert torch.equal(bsr_spmv(zeros, none, torch.zeros(0)), torch.zeros(32))


@pytest.mark.parametrize("bad,exc,match", [
    (lambda b, c, x: (b[0], c, x), ValueError, "R, J, BS, BS"),
    (lambda b, c, x: (b.double(), c, x.double()), TypeError, "float32 or bfloat16"),
    (lambda b, c, x: (b, c, x.bfloat16()), TypeError, "like blocks"),
    (lambda b, c, x: (b, c.long(), x), TypeError, "int32"),
    (lambda b, c, x: (b, c[:, :1].contiguous(), x), ValueError, "block_cols must have"),
    (lambda b, c, x: (b, c, x[:-1]), ValueError, "multiple of 8"),
    (lambda b, c, x: (b, c.t().contiguous().t(), x), ValueError, "contiguous"),
])
def test_spmv_checks_its_inputs(bad, exc, match):
    blocks = torch.zeros((3, 2, 8, 8))
    cols = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(exc, match=match):
        bsr_spmv(*bad(blocks, cols, torch.zeros(24)))


def test_bsr_update_island():
    y = torch.tensor([1.0, 2.0, 0.0, 3.0])
    wl1 = torch.tensor([1.0, 0.0, 0.0, 1.0])
    wall = torch.tensor([4.0, 4.0, 0.0, 8.0])
    f = torch.tensor([0.1, 0.2, 0.3, 0.4])
    got = bsr_update_island(y, wl1, wall, f)
    assert torch.equal(got, torch.tensor([0.5, 0.5, 0.3, 0.5]))


# --------------------------------------------------------------------- #
# the registry and the one-shot solve
# --------------------------------------------------------------------- #
def test_registry_declares_bsr_never_auto():
    assert "bsr" in ops.backend_names()
    spec = ops.backend_spec("bsr")
    assert spec.run is ops.propagate_bsr and spec.block_size is not None
    assert ops.bsr_block_size("cuda") == ops.bsr_block_size("cpu") == 8
    assert ops.bsr_auto_fill_min("cuda") == ops.bsr_auto_fill_min("cpu") == 2.0 / 8
    for hw, auto in (("cuda", "ell_cuda"), ("cpu", "ref")):
        for fill in (None, 0.0, 0.02, 0.5, 1.0):
            info = ops.ProblemInfo(device_type=hw, num_rows=1 << 20, block_fill=fill)
            assert not spec.auto_eligible(info)
            assert ops.select_backend(None, device=hw, num_rows=1 << 20,
                                      block_fill=fill) == auto
        assert "bsr" not in ops.backend_candidates(None, device=hw)
        assert ops.backend_candidates("bsr", device=hw) == ("bsr",)
    assert ops.select_backend("bsr", device="cpu") == "bsr"


def test_slot_map_arm_validates():
    _, tp = _pair(0, 64)
    f0, fr = torch.full((64,), 0.5), torch.ones(64, dtype=torch.bool)
    slot = ell_bsr_layout(tp.nbr.numpy(), 8).slot
    with pytest.raises(ValueError, match="needs num_slots"):
        ops.propagate_bsr(tp, f0, fr, slot=slot)
    with pytest.raises(ValueError, match="tile slots"):
        ops.propagate_bsr(tp, f0, fr, slot=slot, num_slots=int(slot.max()))
    _, odd = _pair(0, 60)
    with pytest.raises(ValueError, match="multiple of block_size"):
        ops.propagate_bsr(odd, f0[:60], fr[:60], slot=slot[:60], num_slots=64)
    with pytest.raises(ValueError, match="takes no slot map"):
        ops.run_propagation(tp, f0, fr, backend="ref", device="cpu", slot=slot, num_slots=8)


@pytest.mark.parametrize("seed,n,frontier_p", [(0, 100, 1.0), (1, 203, 0.3), (2, 256, 0.1)])
def test_one_shot_solve_matches_reference(seed, n, frontier_p):
    """``propagate_bsr`` without a slot map orders, lays out and folds back
    itself; on the same problem it reaches the reference's fixpoint within
    20·δ, and the slot-map arm given the same order gives the same bits."""
    jp, tp = _pair(seed, n)
    rng = np.random.default_rng(seed + 100)
    f0 = rng.uniform(0, 1, n).astype(np.float32)
    fr = rng.random(n) < frontier_p
    got = ops.run_propagation(tp, torch.from_numpy(f0), torch.from_numpy(fr), delta=DELTA,
                              backend="bsr", device="cpu")
    want = jops.propagate_bsr(jp, jnp.asarray(f0), jnp.asarray(fr), delta=DELTA,
                              block_size=8, interpret=True)
    assert got.converged and bool(want.converged)
    assert got.f.shape == (n,)
    assert np.abs(got.f.numpy() - np.asarray(want.f)).max() <= 20 * DELTA
    # the sweep counts may differ by the rows whose residual straddles δ
    assert abs(got.iterations - int(want.iterations)) <= max(1, 0.05 * got.iterations), \
        (got.iterations, int(want.iterations))
    ell = ops.run_propagation(tp, torch.from_numpy(f0), torch.from_numpy(fr), delta=DELTA,
                              backend="ref", device="cpu")
    assert np.abs(got.f.numpy() - ell.f.numpy()).max() <= 20 * DELTA


# --------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------- #
def _record_staging(eng):
    """Wrap the engine's ``_stage_single`` to keep each batch's decision."""
    seen = []
    inner = eng._stage_single

    def wrapped(host):
        st = inner(host)
        seen.append(st)
        return st

    eng._stage_single = wrapped
    return seen


def test_engine_matches_reference_engine():
    """A mixed insert/delete stream through both ``bsr`` engines: the rung
    keys, slot budgets, the reordered staged ``nbr`` and slot map of every
    batch are byte-identical, and the labels agree within BSR_ATOL."""
    spec = dict(total_vertices=240, batch_size=60, emb_dim=EMB_DIM, seed=9, class_sep=6.0,
                noise=0.9, frac_deleted=0.15, frac_unlabeled=0.84)
    jg, tg = jdyn.DynamicGraph(EMB_DIM, k=5), DynamicGraph(EMB_DIM, k=5)
    je = JaxStreamEngine(jg, delta=DELTA, backend="bsr")
    te = StreamEngine(tg, delta=DELTA, backend="bsr", device="cpu")
    jseen, tseen = _record_staging(je), _record_staging(te)
    for (jb, _), (tb, _) in zip(jsynth.gaussian_mixture_stream(jsynth.StreamSpec(**spec)),
                                tsynth.gaussian_mixture_stream(tsynth.StreamSpec(**spec))):
        js, ts = je.step(jb), te.step(tb)
        assert (js.backend, ts.backend) == ("bsr", "bsr")
        assert js.bucket == ts.bucket and ts.converged
        jst, tst = jseen[-1], tseen[-1]
        assert tst.staged.nbr.tobytes() == np.asarray(jst.staged.nbr).tobytes()
        assert tst.slot.tobytes() == np.asarray(jst.slot).tobytes()
        assert tst.perm.tobytes() == np.asarray(jst.perm).tobytes()
        assert tst.num_slots == jst.num_slots
        for name in ("src", "dst", "wgt", "knn_idx", "knn_wgt", "alive", "labels"):
            assert getattr(tg, name).tobytes() == getattr(jg, name).tobytes(), name
        ids = np.flatnonzero(tg.alive & (tg.labels == UNLABELED))
        assert np.abs(tg.f[ids] - jg.f[ids]).max(initial=0) <= BSR_ATOL
    assert te.bucket_keys == je.bucket_keys
    assert te._slot_budgets == je._slot_budgets
    jsum, tsum = je.transport_summary(), te.transport_summary()
    for key in ("requested_backend", "rung_backends", "slot_budgets", "bsr_batches",
                "backend_overflows"):
        assert tsum[key] == jsum[key], key


def _ref_pair(spec, **kw):
    gb, gr = DynamicGraph(EMB_DIM, k=5), DynamicGraph(EMB_DIM, k=5)
    eb = StreamEngine(gb, delta=DELTA, backend="bsr", device="cpu", **kw)
    er = StreamEngine(gr, delta=DELTA, backend="ref", device="cpu")
    return gb, gr, eb, er


def test_engine_matches_its_ref_engine_and_dynlp():
    """The port's ``bsr`` engine against its ``ref`` engine within
    BSR_ATOL, every solved batch on ``bsr``; and ``DynLP(backend="bsr")``,
    which orders and lays out each batch itself, gives the engine's bits
    (the same order, the same slots, so the same sums)."""
    spec = tsynth.StreamSpec(total_vertices=300, batch_size=60, emb_dim=EMB_DIM, seed=9,
                             class_sep=6.0, noise=0.9, frac_deleted=0.15, frac_unlabeled=0.84)
    gb, gr, eb, er = _ref_pair(spec)
    gd = DynamicGraph(EMB_DIM, k=5)
    dyn = DynLP(gd, delta=DELTA, backend="bsr", device="cpu")
    stats = []
    for batch, _ in tsynth.gaussian_mixture_stream(spec):
        stats.append(eb.step(batch))
        er.step(batch)
        sd = dyn.step(batch)
        assert sd.iterations == stats[-1].iterations
        assert gd.f.tobytes() == gb.f.tobytes()
    assert {s.backend for s in stats} == {"bsr"} and all(s.converged for s in stats)
    assert eb.bsr_batches == len(stats) and eb.backend_overflows == 0
    summary = eb.transport_summary()
    assert set(summary["rung_backends"].values()) == {"bsr"}
    assert all(b >= 1 for b in summary["slot_budgets"].values())
    assert all(u % 8 == 0 for u, _ in eb.bucket_keys)
    np.testing.assert_allclose(gb.f, gr.f, atol=BSR_ATOL)


def test_pipelined_engine_gives_the_stepped_engines_bits():
    spec = tsynth.StreamSpec(total_vertices=200, batch_size=50, emb_dim=EMB_DIM, seed=2,
                             class_sep=6.0, noise=0.9)
    gp, gs = DynamicGraph(EMB_DIM, k=5), DynamicGraph(EMB_DIM, k=5)
    ep = StreamEngine(gp, delta=DELTA, backend="bsr", device="cpu")
    es = StreamEngine(gs, delta=DELTA, backend="bsr", device="cpu")
    for batch, _ in tsynth.gaussian_mixture_stream(spec):
        ep.submit(batch)
        es.step(batch)
    assert ep.drain().backend == "bsr"
    assert gp.f.tobytes() == gs.f.tobytes()
    ep.close()


def test_empty_frontier_noop_commits():
    """A no-op Δ_t on a bsr engine stages nothing but still commits, and
    the next real batch resumes on bsr."""
    rng = np.random.default_rng(2)
    g = DynamicGraph(emb_dim=4, k=3)
    eng = StreamEngine(g, delta=DELTA, backend="bsr", device="cpu")
    emb = rng.normal(0, 1, (24, 4)).astype(np.float32)
    emb[0, 0], emb[1, 0] = 3.0, -3.0
    labels = np.full(24, UNLABELED, np.int8)
    labels[0], labels[1] = 1, 0
    eng.step(BatchUpdate(ins_emb=emb, ins_labels=labels, del_ids=NONE))
    st = eng.step(BatchUpdate(ins_emb=np.zeros((0, 4), np.float32),
                              ins_labels=np.zeros(0, np.int8), del_ids=NONE))
    assert st.converged and st.backend == "none" and st.transport == "none"
    st = eng.step(BatchUpdate(
        ins_emb=rng.normal([3, 0, 0, 0], 0.1, (8, 4)).astype(np.float32),
        ins_labels=np.full(8, UNLABELED, np.int8), del_ids=NONE))
    assert st.converged and st.backend == "bsr"
    assert eng.commits == 3 and eng.bsr_batches == 2


def test_slot_budget_overflow_falls_back_with_warning(caplog):
    """A Δ_t whose tile-slot requirement exceeds the rung's budget runs on
    ``ell_cuda`` (its plain version here), warned once per rung, counted in
    ``backend_overflows``, and the labels still track ``ref``."""
    spec = tsynth.StreamSpec(total_vertices=240, batch_size=60, emb_dim=EMB_DIM, seed=5,
                             class_sep=6.0, noise=0.9)
    g, gr, eng, ref = _ref_pair(spec)
    stats = []
    with caplog.at_level(logging.WARNING, logger="repro_torch.core.stream"):
        for i, (batch, _) in enumerate(tsynth.gaussian_mixture_stream(spec)):
            stats.append(eng.step(batch))
            ref.step(batch)
            if i == 0:  # sabotage every known rung's budget
                for key in list(eng._slot_budgets):
                    eng._slot_budgets[key] = 1
    fallbacks = [s for s in stats if s.backend == "ell_cuda"]
    assert fallbacks, "sabotaged slot budget never overflowed"
    assert eng.backend_overflows == len(fallbacks)
    assert eng.bsr_batches + len(fallbacks) == len(stats)
    assert eng.transport_summary()["backend_overflows"] == len(fallbacks)
    warned = [r for r in caplog.records if "tile slots" in r.getMessage()]
    assert warned and len(warned) <= len(eng.bucket_keys)
    np.testing.assert_allclose(g.f, gr.f, atol=BSR_ATOL)


def test_default_engine_does_not_pad_for_bsr():
    """An engine whose backend knob cannot reach bsr pads no rows to the
    tile edge and reports no slot budgets."""
    g = DynamicGraph(EMB_DIM, k=5)
    eng = StreamEngine(g, delta=DELTA, device="cpu")
    assert eng._row_multiple is None and "bsr" not in eng._backend_candidates
    spec = tsynth.StreamSpec(total_vertices=120, batch_size=60, emb_dim=EMB_DIM, seed=1,
                             class_sep=6.0, noise=0.9)
    for batch, _ in tsynth.gaussian_mixture_stream(spec):
        assert eng.step(batch).backend == "ref"
    summary = eng.transport_summary()
    assert summary["requested_backend"] == "auto" and summary["slot_budgets"] == {}
    assert summary["bsr_batches"] == summary["backend_overflows"] == 0
