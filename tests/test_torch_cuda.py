"""The port on the card: the CUDA kernels (frontier sweep, argkmin, BSR
SpMV, Shiloach–Vishkin step and fixpoint) against their plain versions,
and the main paths through them.  Every test here needs an NVIDIA GPU and
skips without one; this file imports neither jax nor the reference, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import ctypes
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.core.distributed import DeviceMesh
from repro_torch.core.dynlp import DynLP
from repro_torch.core.stream import StreamEngine
from repro_torch.data.synth import StreamSpec, gaussian_mixture_stream
from repro_torch.graph.dynamic import DynamicGraph
from repro_torch.graph.knn import SELECT_MARGIN, normalize_rows, selection_slack
from repro_torch.kernels.argkmin import (argkmin_candidates, argkmin_launch, argkmin_ref,
                                         shard_sweep)
from repro_torch.kernels.bsr_spmv import bsr_spmv, bsr_spmv_ref
from repro_torch.kernels import _build
from repro_torch.kernels.cc_hook import (cc_fixpoint, cc_hook_ref, cc_hook_step,
                                         connected_components_cuda, connected_components_ref)
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


def _sweep_inputs(rng, n, k, nf, frontier, pad_rows=0.0):
    """Sweep inputs (numpy) with a frontier that is all on, all off, one
    row per 32-row warp, or random; ``pad_rows`` of the rows all PAD."""
    nbr = rng.integers(-1, nf, size=(n, k)).astype(np.int32)
    nbr[rng.random(n) < pad_rows] = -1
    wgt = (rng.uniform(0.1, 1.0, (n, k)) * (nbr >= 0)).astype(np.float32)
    wl0 = (rng.uniform(0, 1, n) * (rng.random(n) < 0.3)).astype(np.float32)
    wl1 = (rng.uniform(0, 1, n) * (rng.random(n) < 0.3)).astype(np.float32)
    fr = {"all": np.ones(n, bool), "none": np.zeros(n, bool),
          "one_per_warp": np.arange(n) % 32 == 7, "random": rng.random(n) < 0.4}[frontier]
    return [nbr, wgt, wl0, wl1, fr, rng.uniform(0, 1, nf).astype(np.float32)]


@pytest.mark.parametrize("k", [1, 24, 32, 33, 64])
@pytest.mark.parametrize("frontier", ["all", "none", "one_per_warp", "random"])
def test_sweep_kernel_chunks_and_frontiers(card, k, frontier):
    """The warp-cooperative sweep: one column chunk (K <= 32) or several,
    every frontier pattern, a ragged last warp, all-PAD rows; the same
    bits."""
    n = 3000 + k
    args = [torch.from_numpy(a).to(card) for a in
            _sweep_inputs(np.random.default_rng(k), n, k, n, frontier, pad_rows=0.1)]
    got = ell_propagate_step(*args, delta=DELTA)
    want = ell_propagate_ref(*args, delta=DELTA)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("k", [8, 24, 40])
@pytest.mark.parametrize("rows_per_warp", [1, 7, 8, 9, 23, 24, 25, 32])
def test_sweep_kernel_launch_geometries(card, k, rows_per_warp):
    """Both walks of a chunk (by frontier row while a warp has fewer
    frontier rows than the chunk's columns, else flat), on either side of
    the switch and across a second, narrower chunk (K = 40: 32 + 8
    columns), give the plain version's bits."""
    n = 2000
    rng = np.random.default_rng(k * 100 + rows_per_warp)
    arrays = _sweep_inputs(rng, n, k, n, "none", pad_rows=0.1)
    for w0 in range(0, n, 32):
        lanes = min(32, n - w0)
        arrays[4][w0 + rng.choice(lanes, min(rows_per_warp, lanes), replace=False)] = True
    args = [torch.from_numpy(a).to(card) for a in arrays]
    got = ell_propagate_step(*args, delta=DELTA)
    want = ell_propagate_ref(*args, delta=DELTA)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("k,nf,row_offset", [(24, 5000, 4500), (33, 1300, 700), (1, 900, 1)])
def test_sweep_kernel_row_offset_clamps(card, k, nf, row_offset):
    """Rows past Nf - 1 - row_offset read the clamped F_u."""
    n = 1000
    args = [torch.from_numpy(a).to(card) for a in
            _sweep_inputs(np.random.default_rng(nf), n, k, nf, "random")]
    got = ell_propagate_step(*args, delta=DELTA, row_offset=row_offset)
    want = ell_propagate_ref(*args, delta=DELTA, row_offset=row_offset)
    torch.cuda.synchronize()
    assert row_offset + n > nf
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("which", ["nbr", "wgt"])
def test_sweep_kernel_rows_off_16_bytes(card, which):
    """An array that starts one entry past a 16-byte boundary (a view into
    a larger buffer): the same bits."""
    n, k = 1000, 24
    args = [torch.from_numpy(a).to(card) for a in
            _sweep_inputs(np.random.default_rng(5), n, k, n, "random")]
    i = ("nbr", "wgt").index(which)
    buf = torch.empty(n * k + 1, dtype=args[i].dtype, device=card)
    args[i] = buf[1:].view(n, k).copy_(args[i])
    assert args[i].data_ptr() % 16 == 4
    got = ell_propagate_step(*args, delta=DELTA)
    want = ell_propagate_ref(*args, delta=DELTA)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


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


def _argkmin_case(rng, case, c=3000, d=16, m=200):
    """argkmin inputs (numpy) that put the top-TK where the thresholded
    splits find it hardest: all in the first split (the lowest rows), all
    in the last split, or mass ties at the TK-th value across every split
    boundary."""
    args, base = _argkmin_inputs(rng, c, d, m, c)
    emb, batch = args[0].numpy(), args[3].numpy()
    if case == "top_in_first_split":
        emb[:64] = batch[np.arange(64) % m]
    elif case == "top_in_last_split":
        emb[base - 64:base] = batch[np.arange(64) % m]
    elif case == "ties_at_the_kth":
        emb[: base: 3] = emb[1]
        batch[:] = emb[1]
        emb[base:] = batch
    return args, base


@pytest.mark.parametrize("case", ["random", "top_in_first_split", "top_in_last_split",
                                  "ties_at_the_kth"])
@pytest.mark.parametrize("topk", [1, 8, 9, 13, 16, 17, 32])
def test_argkmin_list_bounds_and_seed_threshold(card, case, topk):
    """Every list bound (TK on both sides of 8, 16, 32), M not a multiple of
    the block rows, the top-TK in the first split, in the last split, or
    tied at a list's threshold (its TK-th value) across the splits: values,
    ids and mask equal the plain version's."""
    args, base = _argkmin_case(np.random.default_rng(topk), case)
    args = [a.to(card) for a in args]
    slack = selection_slack(16)
    want = argkmin_ref(*args, base, slack, topk=topk)
    got = argkmin_launch(*args, base, slack, topk=topk)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), g.dtype


@pytest.mark.parametrize("c,d,m", [(300, 16, 8), (257, 128, 3), (1, 8, 1), (2000, 32, 300),
                                   (2000, 40, 129)])
def test_argkmin_store_below_one_split(card, c, d, m):
    """C below one split of the main path; M one past a block's rows."""
    args, base = _argkmin_inputs(np.random.default_rng(c), c, d, m, c)
    args = [a.to(card) for a in args]
    topk = min(13, c)
    got = argkmin_launch(*args, base, selection_slack(d), topk=topk)
    want = argkmin_ref(*args, base, selection_slack(d), topk=topk)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("row0,base_id", [(16384, 20000), (16384, 10000), (16384, 40000),
                                          (114688, 103192), (0, 2900)])
def test_argkmin_at_a_row_offset(card, row0, base_id):
    """One store block at global offset ``row0`` (a shard of a row-sharded
    store), the batch's rows inside the block, before it or after it: the
    kernel gives the plain version's bits, ids global."""
    rng = np.random.default_rng(row0 + base_id)
    c, d, m = 16384, 16, 300
    args, _ = _argkmin_inputs(rng, c, d, m, c)
    args = [a.to(card) for a in args]
    if row0 <= base_id < row0 + c - m:
        args[0][base_id - row0:base_id - row0 + m] = args[3]
    slack = selection_slack(d)
    got = argkmin_launch(*args, base_id, slack, topk=13, row0=row0)
    want = argkmin_ref(*args, base_id, slack, topk=13, row0=row0)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    fin = torch.isfinite(got[0])
    assert bool(((got[1][fin] >= row0) & (got[1][fin] < row0 + c)).all())


@pytest.mark.parametrize("dup", [False, True])
def test_shard_sweep_on_the_card(card, dup):
    """Eight shards of one card: one launch a shard at its row0, the merged
    lists and the mask equal to one launch over the whole store."""
    c, d, m = 8192, 16, 500
    args, base = _argkmin_inputs(np.random.default_rng(5 + dup), c, d, m, 7000, dup)
    args = [a.to(card) for a in args]
    slack = selection_slack(d)
    whole = argkmin_launch(*args, base, slack, topk=13)
    before = argkmin_candidates.launches
    cut = [t.view(8, -1, *t.shape[1:]).unbind(0) for t in args[:3]]
    got = shard_sweep(*(tuple(x.contiguous() for x in part) for part in cut), (args[3],) * 8,
                      (args[4],) * 8, base, slack, topk=13)
    torch.cuda.synchronize()
    assert argkmin_candidates.launches == before + 8
    for g, w in zip(got, whole):
        assert torch.equal(g, w)


@pytest.mark.parametrize("transport", ["allgather", "halo"])
def test_mesh_stream_on_two_shards(card, transport):
    """A two-shard mesh on the card streams with device ingest to the
    single-device engine's labels bit for bit; the sweep kernel runs once
    a shard a sweep, argkmin once a shard an inserting batch."""
    spec = StreamSpec(total_vertices=1500, batch_size=300, seed=4, class_sep=6.0, noise=0.9)
    batches = [b for b, _ in gaussian_mixture_stream(spec)]
    single = StreamEngine(DynamicGraph(emb_dim=spec.emb_dim, k=5), delta=DELTA,
                          ingest="device")
    eng = StreamEngine(DynamicGraph(emb_dim=spec.emb_dim, k=5), delta=DELTA, ingest="device",
                       mesh=DeviceMesh.local(2), transport=transport)
    assert eng.device == torch.device("cuda", torch.cuda.current_device())
    for b in batches:
        single.step(b)
    sweeps0, ak0 = ell_propagate_step.launches, argkmin_candidates.launches
    stats = [eng.step(b) for b in batches]
    assert ell_propagate_step.launches - sweeps0 == 2 * sum(s.iterations for s in stats)
    assert argkmin_candidates.launches - ak0 == 2 * len(batches)
    assert eng.graph.f.tobytes() == single.graph.f.tobytes()
    assert {s.transport for s in stats} <= {"allgather", "halo"}


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


def _bsr_inputs(rng, r, j, bs, c, empty=0.3, bare_rows=0.0, dtype=torch.float32):
    """Random row-padded BSR tiles: a share ``empty`` of the slots is
    empty (-1, zero tile), and ``bare_rows`` of the block rows have none."""
    cols = rng.integers(0, c, size=(r, j)).astype(np.int32)
    cols[rng.random((r, j)) < empty] = -1
    cols[rng.random(r) < bare_rows] = -1
    blocks = rng.normal(0, 1, (r, j, bs, bs)).astype(np.float32)
    blocks[cols < 0] = 0.0
    x = rng.normal(0, 1, c * bs).astype(np.float32)
    return (torch.from_numpy(blocks).to(dtype), torch.from_numpy(cols),
            torch.from_numpy(x).to(dtype))


@pytest.mark.parametrize("r,j,bs,c,empty,bare,dtype", [
    (13_400, 128, 8, 13_400, 0.45, 0.0, torch.float32),  # the main path's width
    (64, 4, 8, 64, 1.0, 0.0, torch.float32),  # every slot empty
    (300, 6, 8, 300, 0.2, 0.5, torch.float32),  # block rows without slots
    (500, 1, 16, 500, 0.1, 0.0, torch.float32),  # J = 1
    (40, 5, 32, 97, 0.3, 0.0, torch.float32),  # C != R
    (6, 3, 128, 9, 0.2, 0.0, torch.float32),  # BS = 128
    (80, 7, 8, 80, 0.3, 0.1, torch.bfloat16),  # bfloat16 tiles and x
])
def test_bsr_spmv_kernel_gives_the_plain_versions_bits(card, r, j, bs, c, empty, bare, dtype):
    args = [a.to(card) for a in _bsr_inputs(np.random.default_rng(r + j + bs), r, j, bs, c,
                                            empty, bare, dtype)]
    before = bsr_spmv.launches
    got = bsr_spmv(*args)
    want = bsr_spmv_ref(*args)
    torch.cuda.synchronize()
    assert bsr_spmv.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (r * bs,)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("n,k,pad", [(107_200, 24, 0.4), (1000, 1, 0.5), (777, 5, 1.0)])
def test_cc_hook_kernel_gives_the_plain_versions_result(card, n, k, pad):
    rng = np.random.default_rng(n + k)
    nbr = rng.integers(0, n, size=(n, k)).astype(np.int32)
    nbr[rng.random((n, k)) < pad] = -1
    nbr = torch.from_numpy(nbr).to(card)
    par = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(card)
    before = cc_hook_step.launches
    got = cc_hook_step(nbr, par)
    torch.cuda.synchronize()
    assert cc_hook_step.launches == before + 1
    assert torch.equal(got, cc_hook_ref(nbr, par))
    labels, iters = connected_components_cuda(nbr)
    cpu_labels, cpu_iters = connected_components_cuda(nbr.cpu())
    assert torch.equal(labels.cpu(), cpu_labels) and iters == cpu_iters


def _cc_case(card, n, k, pad, pad_rows=0.0, offset=None):
    """Random directed lanes (a share ``pad`` -1, a share ``pad_rows`` of
    the rows all -1) and a random parent vector on the card; with
    ``offset`` (entries) ``nbr`` is a view that far into a larger buffer."""
    rng = np.random.default_rng(n * 31 + k)
    nbr = rng.integers(0, n, size=(n, k)).astype(np.int32)
    nbr[rng.random((n, k)) < pad] = -1
    nbr[rng.random(n) < pad_rows] = -1
    nbr = torch.from_numpy(nbr).to(card)
    if offset is not None:
        buf = torch.empty(nbr.numel() + offset, dtype=torch.int32, device=card)
        nbr = buf[offset:].view(n, k).copy_(nbr)
        assert nbr.data_ptr() % 16 != 0
    return nbr, torch.from_numpy(rng.permutation(n).astype(np.int32)).to(card)


# the phase-2 cases of chip_smoke.py: K on both sides of 4 and of the
# 32-column chunk, N below and off 32, all-PAD rows, views off 16 bytes
CC_CASES = [(107_200, 24, 0.4, 0.0, None), (1000, 1, 0.5, 0.0, None), (1000, 3, 0.3, 0.0, None),
            (1000, 4, 0.3, 0.0, None), (2000, 33, 0.3, 0.0, None), (1500, 36, 0.2, 0.0, None),
            (20, 24, 0.2, 0.0, None), (1, 4, 0.0, 0.0, None), (3001, 24, 0.2, 0.3, None),
            (300, 0, 0.0, 0.0, None), (4097, 8, 0.1, 0.0, None), (2003, 3, 0.2, 0.0, 3),
            (2033, 33, 0.2, 0.0, 33), (2024, 24, 0.2, 0.0, 1), (2004, 4, 0.2, 0.0, 1)]


@pytest.mark.parametrize("n,k,pad,pad_rows,offset", CC_CASES)
def test_cc_step_and_fixpoint_edge_cases(card, n, k, pad, pad_rows, offset):
    """The warp-cooperative step equals ``cc_hook_ref`` exactly; the
    fixpoint equals the host loop of ``cc_hook_ref`` (labels and step
    count) in exactly one launch."""
    nbr, par = _cc_case(card, n, k, pad, pad_rows, offset)
    assert torch.equal(cc_hook_step(nbr, par), cc_hook_ref(nbr, par))
    before, steps = connected_components_cuda.launches, cc_hook_step.launches
    labels, iters = connected_components_cuda(nbr)
    assert connected_components_cuda.launches == before + 1
    assert cc_hook_step.launches == steps
    want, want_iters = connected_components_ref(nbr)
    assert torch.equal(labels, want) and iters == want_iters


def _path(card, n):
    nbr = np.full((n, 2), -1, np.int32)
    nbr[1:, 0] = np.arange(n - 1)
    nbr[:-1, 1] = np.arange(1, n)
    return torch.from_numpy(nbr).to(card)


@pytest.mark.parametrize("max_iters", [0, 1, 2, 3, 10_000])
def test_cc_fixpoint_honours_max_iters(card, max_iters):
    nbr = _path(card, 300)
    labels, iters = connected_components_cuda(nbr, max_iters=max_iters)
    want, want_iters = connected_components_ref(nbr, max_iters=max_iters)
    assert torch.equal(labels, want) and iters == want_iters == min(max_iters, want_iters)
    if max_iters == 10_000:
        assert (labels == 0).all() and iters > 3


def test_cc_fixpoint_without_edges_and_rows(card):
    labels, iters = connected_components_cuda(torch.full((500, 6), -1, dtype=torch.int32,
                                                         device=card))
    assert torch.equal(labels, torch.arange(500, dtype=torch.int32, device=card)) and iters == 1
    before = connected_components_cuda.launches
    labels, iters = connected_components_cuda(torch.empty((0, 4), dtype=torch.int32,
                                                          device=card))
    assert labels.numel() == 0 and iters == 1 and connected_components_cuda.launches == before


def _fixpoint_plan(n, k):
    """The fixpoint's launch over (N, K) from its C planner: (blocks, row
    groups a warp keeps in shared memory, blocks resident)."""
    lib, out = _build.load_library(), (ctypes.c_int * 3)()
    lib.check(lib.lib.cc_fixpoint_plan(n, k, ctypes.addressof(out)), "cc_fixpoint_plan")
    return tuple(out)


def test_cc_fixpoint_grid_limits(card):
    """Rows too many for a warp to keep their lanes in shared memory: every
    resident block, each warp striding over several row groups read from
    device memory at every step, gives the plain loop's result."""
    blocks, kept, resident = _fixpoint_plan(1_000_000, 24)
    assert resident >= 132 and blocks == resident and kept == 0
    nbr, _ = _cc_case(card, 1_000_000, 24, 0.4)
    want, want_iters = connected_components_ref(nbr)
    labels, iters = cc_fixpoint(nbr)
    assert torch.equal(labels, want) and int(iters) == want_iters


def test_cc_fixpoint_refused_launch_raises(card, monkeypatch):
    """A cooperative launch the card refuses raises through ``lib.check``
    and counts no launch; nothing falls back to the host loop."""
    nbr, _ = _cc_case(card, 5000, 24, 0.3)
    real = _build.load_library()
    refusing = types.SimpleNamespace(
        cc_fixpoint=lambda *args: 720,  # cudaErrorCooperativeLaunchTooLarge
        repro_cuda_error_string=real.lib.repro_cuda_error_string)
    monkeypatch.setattr(_build, "load_library", lambda: dataclasses.replace(real, lib=refusing))
    before, steps = connected_components_cuda.launches, cc_hook_step.launches
    with pytest.raises(RuntimeError, match="cooperative launch: CUDA error 720"):
        connected_components_cuda(nbr)
    assert connected_components_cuda.launches == before and cc_hook_step.launches == steps


def test_cc_fixpoint_keeps_the_main_paths_lanes(card):
    """At the main path's width the grid is every resident block (or what
    the rows need), every warp keeps its rows' lanes in shared memory, and
    the result is the plain loop's."""
    blocks, kept, resident = _fixpoint_plan(107_200, 24)
    assert blocks == min(resident, 419) and kept >= 1
    nbr, _ = _cc_case(card, 107_200, 24, 0.4)
    labels, iters = connected_components_cuda(nbr)
    want, want_iters = connected_components_ref(nbr)
    assert torch.equal(labels, want) and iters == want_iters


def test_cc_fixpoint_counts_one_launch_per_call(card):
    nbr, _ = _cc_case(card, 5000, 24, 0.3)
    before, steps = connected_components_cuda.launches, cc_hook_step.launches
    for i in range(3):
        connected_components_cuda(nbr)
        assert connected_components_cuda.launches == before + i + 1
    assert cc_hook_step.launches == steps


def test_bsr_stream_goes_through_the_spmv_kernel(card):
    """``StreamEngine(backend="bsr")`` on the card launches the SpMV once
    per sweep, and its labels are within 20·δ of a CPU ``ref`` engine's."""
    spec = StreamSpec(total_vertices=900, batch_size=300, seed=3, class_sep=6.0, noise=0.8)
    gg, gc = DynamicGraph(16, 5), DynamicGraph(16, 5)
    eng = StreamEngine(gg, delta=DELTA, backend="bsr")
    ref = StreamEngine(gc, delta=DELTA, backend="ref", device="cpu")
    before = bsr_spmv.launches
    sweeps = 0
    for batch, _ in gaussian_mixture_stream(spec):
        st = eng.step(batch)
        assert st.backend == "bsr"
        sweeps += st.iterations
        ref.step(batch)
    assert bsr_spmv.launches - before == sweeps > 0
    assert eng.backend_overflows == 0
    ids = np.flatnonzero(gg.alive & (gg.labels == -1))
    assert np.abs(gg.f[ids] - gc.f[ids]).max() <= 20 * DELTA


# --------------------------------------------------------------------- #
# the serving and persistence slice on the card
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [1, 300, 100_000])
def test_device_view_gather_equals_the_host_view(card, n):
    """The committed view on the card, published on its read stream,
    answers exactly as the host ``LabelView`` for every kind of id."""
    from repro_torch.core.snapshot import LabelView, publish_device_view

    rng = np.random.default_rng(n)
    labels = np.where(rng.random(n) < 0.2, rng.integers(0, 2, n), -1).astype(np.int8)
    view = LabelView(f=rng.random(n).astype(np.float32), labels=labels,
                     alive=rng.random(n) > 0.1, commit_id=5)
    with pytest.raises(ValueError, match="stream"):
        publish_device_view(view, card)
    stream = torch.cuda.Stream()
    dv = publish_device_view(view, card, stream)
    assert dv.f.device.type == "cuda" and dv.stream is stream
    ids = np.concatenate([rng.integers(-5, n + 5, 5000),
                          [2 ** 31, -2 ** 31 - 1, 2 ** 40]]).astype(np.int64)
    for cutoff in (0.5, 0.3):
        got, want = dv.query(ids, cutoff), view.query(ids, cutoff)
        for a, b in zip(got, want):
            assert a.tobytes() == b.tobytes()
    per_id = rng.random(len(ids)).astype(np.float32)
    pred, conf = dv.query(ids, per_id)
    for i in range(0, len(ids), 97):
        p, c = view.query(ids[i:i + 1], per_id[i])
        assert (pred[i], conf[i]) == (p[0], c[0])
    empty = dv.query(np.zeros(0, np.int64))
    assert empty[0].shape == empty[1].shape == (0,)


def test_lp_service_round_trip_with_the_driver(card):
    """An ``LPService`` over a device-ingest engine on the card with its
    driver running: readers in threads while windows commit, every answer
    equal to the host view of its own commit, argkmin once per window with
    insertions and the sweep kernel once per sweep."""
    import threading

    from repro_torch.serving.lp_service import LPService

    spec = StreamSpec(total_vertices=3000, batch_size=300, seed=4, class_sep=6.0, noise=0.9)
    g = DynamicGraph(16, 5)
    eng = StreamEngine(g, delta=DELTA, ingest="device")
    views, stats, submits = {0: eng.committed_view()}, [], []
    real_drain, real_submit = eng.drain, eng.submit

    def drain():
        st = real_drain()
        if st is not None:
            stats.append(st)
            views[eng.commits] = eng.committed_view()
        return st

    def submit(batch):
        submits.append(len(batch.ins_emb) > 0)
        return real_submit(batch)

    eng.drain, eng.submit = drain, submit
    svc = LPService(eng, window_ops=300, window_ms=5.0)
    stop, results, errors = threading.Event(), [], []

    def reader(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            ids = rng.integers(-10, 3100, 256)
            try:
                r = svc.query(ids)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)
                return
            results.append((ids, r))

    a0, s0 = argkmin_candidates.launches, ell_propagate_step.launches
    with svc:
        threads = [threading.Thread(target=reader, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        for batch, _ in gaussian_mixture_stream(spec):
            for lo in range(0, len(batch.ins_emb), 100):
                svc.add_points(batch.ins_emb[lo:lo + 100], batch.ins_labels[lo:lo + 100])
            if len(batch.del_ids):
                svc.remove_points(batch.del_ids)
        svc.sync()
        stop.set()
        for th in threads:
            th.join(60.0)
        assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    st = svc.stats()
    assert st.batches_admitted == st.batches_committed == len(stats) == len(submits)
    assert argkmin_candidates.launches - a0 == sum(submits)
    assert ell_propagate_step.launches - s0 == sum(s.iterations for s in stats) > 0
    assert results and st.read_tickets >= len(results)
    for ids, r in results:
        p, c = views[r.commit_id].query(ids)
        assert r.pred.tobytes() == p.tobytes() and r.confidence.tobytes() == c.tobytes()


def test_checkpoint_round_trip_of_a_device_ingest_engine(card, tmp_path):
    """Checkpoint a device-ingest engine on the card, restore it on the
    card: graph, store and answers byte-identical, and both go on to the
    same graph and labels."""
    spec = StreamSpec(total_vertices=2400, batch_size=400, seed=6, class_sep=6.0, noise=0.9)
    batches = [b for b, _ in gaussian_mixture_stream(spec)]
    eng = StreamEngine(DynamicGraph(16, 5), delta=DELTA, ingest="device")
    for b in batches[:3]:
        eng.step(b)
    eng.checkpoint(str(tmp_path))
    r = StreamEngine.restore(str(tmp_path))
    assert r.device.type == "cuda" and r.ingestor.store.emb.device.type == "cuda"
    for name in ("emb", "valid", "kth"):
        assert torch.equal(getattr(r.ingestor.store, name), getattr(eng.ingestor.store, name))
    for b in batches[3:]:
        eng.step(b)
        r.step(b)
    for name in ("f", "labels", "alive", "knn_idx", "knn_wgt", "src", "dst", "wgt"):
        assert getattr(r.graph, name).tobytes() == getattr(eng.graph, name).tobytes(), name
    ids = np.arange(-3, eng.graph.num_nodes + 3)
    for a, b in zip(r.device_view().query(ids), eng.device_view().query(ids)):
        assert a.tobytes() == b.tobytes()


# --------------------------------------------------------------------- #
# the baselines and the landmark backend on the card
# --------------------------------------------------------------------- #
def test_propagate_full_ell_gives_propagate_fulls_bits(card):
    """ITLP's iteration through the sweep kernel (every valid row on, a
    launch a sweep) against the plain ``propagate_full`` on the card: F's
    bits and the iteration count, padding rows left at f0."""
    from repro_torch.core.propagate import PropagationProblem, propagate_full
    from repro_torch.kernels.ops import propagate_full_ell

    rng = np.random.default_rng(17)
    args = _sweep_inputs(rng, 3000, 24, 3000, "all", pad_rows=0.1)
    nbr, wgt, wl0, wl1 = (torch.from_numpy(a).to(card) for a in args[:4])
    valid = torch.arange(3000, device=card) < 2900  # the last 100 rows pad the bucket
    nbr[~valid] = -1
    wgt[~valid] = 0
    wl0[~valid] = 0
    wl1[~valid] = 0
    p = PropagationProblem(nbr=nbr, wgt=wgt, wl0=wl0, wl1=wl1, valid=valid)
    f0 = torch.full((3000,), 0.5, device=card)
    before = ell_propagate_step.launches
    got = propagate_full_ell(p, f0, delta=DELTA)
    launches = ell_propagate_step.launches - before
    want = propagate_full(p, f0, delta=DELTA)
    assert got.converged and launches == got.iterations == want.iterations > 1
    assert torch.equal(got.f.view(torch.int32), want.f.view(torch.int32))
    assert torch.equal(got.f[2900:], f0[2900:])


@pytest.mark.parametrize("c,valid", [(64, 64), (64, 37), (37, 37)])
@pytest.mark.parametrize("m", [1024, 300])
def test_argkmin_at_the_landmark_geometry(card, c, valid, m):
    """The landmark assignment's call: a block of C landmark rows, the
    first ``valid`` of them sampled (the engine pads a partial sample with
    invalid rows), a chunk of 1,024 query rows with ``m`` real,
    ``base_id = C`` (no self-match), k = 4 (TK = 12), kth all ``-inf``:
    the kernel gives its plain version's bits."""
    rng = np.random.default_rng(c + valid + m)
    lm = normalize_rows(rng.normal(0, 1, (c, 16)).astype(np.float32))
    block = np.zeros((1024, 16), np.float32)
    block[:m] = normalize_rows(rng.normal(0, 1, (m, 16)).astype(np.float32))
    args = [torch.from_numpy(lm).to(card), (torch.arange(c) < valid).to(card),
            torch.full((c,), -np.inf, device=card), torch.from_numpy(block).to(card),
            (torch.arange(1024) < m).to(card)]
    before = argkmin_candidates.launches
    got = argkmin_candidates(*args, c, 0.0, k=4)
    want = argkmin_ref(*args, c, 0.0, topk=12)
    torch.cuda.synchronize()
    assert argkmin_candidates.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_landmark_engine_on_the_card_matches_the_cpu(card):
    """A landmark engine of a few thousand vertices on the card and on the
    CPU over the same mixed stream: graph and hot masks equal, the same
    cold rows served, labels within 20·δ; the assignment goes through the
    argkmin kernel (one launch a chunk)."""
    spec = StreamSpec(total_vertices=4000, batch_size=200, seed=11, class_sep=6.0,
                      noise=0.9, frac_deleted=0.2, frac_labeled=0.05)
    cfg = dict(num_landmarks=32, assign_k=4, hot_ttl=3)
    engines = [StreamEngine(DynamicGraph(16, 5), delta=DELTA, backend="landmark",
                            landmark=cfg, device=dev) for dev in (card, "cpu")]
    before = argkmin_candidates.launches
    for b, _ in gaussian_mixture_stream(spec):
        for e in engines:
            e.step(b)
        gg, gc = (e.graph for e in engines)
        assert np.array_equal(engines[0]._touched_at, engines[1]._touched_at)
        for name in ("src", "dst", "wgt", "alive", "labels"):
            assert getattr(gg, name).tobytes() == getattr(gc, name).tobytes(), name
        ids = np.flatnonzero(gc.alive & (gc.labels == -1))
        assert np.abs(gg.f[ids] - gc.f[ids]).max() <= 20 * DELTA
    sg, sc = (e.transport_summary()["landmark"] for e in engines)
    assert sg == sc and sg["streaming"] and sg["cold_rows"] > 0
    assert argkmin_candidates.launches - before == sg["assign_chunks"] > 0


@pytest.mark.parametrize("gamma", [None, 1.0])
def test_stlp_step_on_the_card_matches_the_cpu(card, gamma):
    from repro_torch.core.stlp import STLP

    spec = StreamSpec(total_vertices=2400, batch_size=800, seed=7, class_sep=6.0, noise=0.8)
    graphs = [DynamicGraph(16, 5) for _ in range(2)]
    engines = [STLP(g, gamma=gamma, device=dev) for g, dev in zip(graphs, (card, "cpu"))]
    for b, _ in gaussian_mixture_stream(spec):
        sg, sc = (e.step(b) for e in engines)
        assert sg.num_unlabeled == sc.num_unlabeled
        ids = np.flatnonzero(graphs[1].alive & (graphs[1].labels == -1))
        assert np.abs(graphs[0].f[ids] - graphs[1].f[ids]).max() <= 1e-4


# --------------------------------------------------------------------- #
# the LM serving slice: the model and the pipeline on the card
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["qwen3_0_6b", "h2o_danube_3_4b"])
def test_lm_decode_on_the_card_matches_the_cpu(card, name):
    """Prefill and 20 decode steps (vector ``pos``, row 0 past the 16-row
    cache's end or round h2o's ring) on the card against the CPU on the same
    weights: logits within 0.1, caches within 0.0625 (the bf16 bound of
    ``tests/test_torch_lm.py``: the two devices round bf16 products and
    their sums in different orders).  A write past the cache's end must be
    dropped on the card too, not trip a device-side assert."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.api import build_model

    cfg = get_smoke_config(name)
    cpu = build_model(cfg, device="cpu")
    gpu = build_model(cfg, device=card)
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 20)))
    got, want = gpu.prefill({"tokens": toks.to(card)}), cpu.prefill({"tokens": toks})
    assert (got[0].float().cpu() - want[0].float()).abs().max() <= 0.1
    caches = [gpu.init_cache(2, 16), cpu.init_cache(2, 16)]
    for t in range(20):
        pos = torch.tensor([t, t // 2])
        g, caches[0] = gpu.decode_step(caches[0], {"tokens": toks[:, t:t + 1].to(card),
                                                   "pos": pos.to(card)})
        c, caches[1] = cpu.decode_step(caches[1], {"tokens": toks[:, t:t + 1], "pos": pos})
        assert (g.float().cpu() - c.float()).abs().max() <= 0.1, t
    torch.cuda.synchronize()
    for key in ("k", "v"):
        assert (caches[0][key].float().cpu() - caches[1][key].float()).abs().max() <= 0.0625


def test_pipeline_first_wave_on_the_card_matches_the_cpu(card):
    """The pipeline's first wave on the card (``DynLP`` through the sweep
    kernel) and on the CPU: the graph byte for byte, F within 20·δ,
    launches = iterations."""
    from repro_torch.data.pipeline import PseudoLabelPipeline
    from repro_torch.data.synth import make_documents

    toks, labels, _ = make_documents(np.random.default_rng(0), 2000, 64, 151_936)
    gpu, cpu = PseudoLabelPipeline(k=5), PseudoLabelPipeline(k=5, device="cpu")
    before = ell_propagate_step.launches
    st = gpu.ingest(toks, labels)
    cpu.ingest(toks, labels)
    assert ell_propagate_step.launches - before == st.lp_iterations > 0
    for name in ("src", "dst", "wgt", "knn_idx", "knn_wgt"):
        assert np.array_equal(getattr(gpu.graph, name), getattr(cpu.graph, name)), name
    assert np.abs(gpu.graph.f - cpu.graph.f).max() <= 20 * DELTA
