"""The port's mesh solve against its single-device solve and the reference.

Mirrors ``tests/test_distributed_lp.py``, ``test_halo_lp.py`` and the
partition cases of ``test_stream_transport.py``.  The reference forces 8
virtual CPU devices in a subprocess; the port's mesh is a ``DeviceMesh``
whose shards may share a device, so ``DeviceMesh.local(8, device="cpu")``
runs in process.  Held: the halo plans, budgets and halo-laid-out host
snapshots are the reference's bytes; ``distributed_propagate`` and
``distributed_propagate_halo`` at D = 1, 3 and 8 give the port's
single-device solve bit for bit (F, iterations, convergence, residual) and
are within 20·δ of the reference's ``propagate``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.snapshot import apply_halo_layout as japply_halo_layout
from repro.core.snapshot import build_host_problem as jbuild_host_problem
from repro.data import synth as jsynth
from repro.graph import dynamic as jdyn
from repro.graph import partition as jpart
from repro_torch.core import distributed as dist
from repro_torch.core.distributed import DeviceMesh
from repro_torch.core.propagate import PropagationProblem, propagate
from repro_torch.core.snapshot import apply_halo_layout, build_host_problem
from repro_torch.data.synth import StreamSpec, gaussian_mixture_stream
from repro_torch.graph import partition
from repro_torch.graph.dynamic import DynamicGraph
from repro_torch.kernels import ops
from repro_torch.kernels.bsr_spmv import ell_bsr_layout
from repro_torch.state import problem_from_arrays

from helpers import random_problem, random_undirected_coo

jprop = importlib.import_module("repro.core.propagate")

torch.set_num_threads(1)

DELTA = 1e-4
F_TOL = 20 * DELTA
MESHES = (1, 3, 8)


def _pair(seed, n):
    jp = random_problem(np.random.default_rng(seed), n, 2)
    return jp, problem_from_arrays(*(np.asarray(a) for a in jp), device="cpu")


def _same(a, b):
    assert a.f.numpy().tobytes() == b.f.numpy().tobytes()
    assert (a.iterations, a.converged, a.max_residual) == \
        (b.iterations, b.converged, b.max_residual)


def _laid_out(tp, plan):
    """A problem's rows in the plan's halo layout (padding rows appended)."""
    arrays = [plan.nbr] + [partition.apply_plan(plan, getattr(tp, k).numpy())
                           for k in ("wgt", "wl0", "wl1", "valid")]
    return problem_from_arrays(*arrays, device="cpu")


# ---------------------------------------------------------------------- #
# partition and layout bytes
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n,shards,deg", [(100, 4, 4.0), (203, 8, 6.0), (64, 3, 2.0),
                                          (40, 1, 4.0)])
def test_halo_plan_bytes_match_reference(n, shards, deg):
    from repro.graph.structures import coo_to_csr, csr_to_ell_fast

    rng = np.random.default_rng(n)
    src, dst, wgt = random_undirected_coo(rng, n, deg)
    nbr = np.asarray(csr_to_ell_fast(coo_to_csr(n, src, dst, wgt)).nbr)
    got, want = partition.build_halo_plan(nbr, shards), jpart.build_halo_plan(nbr, shards)
    for name in ("nbr", "perm", "inv_perm", "export_counts"):
        assert getattr(got, name).tobytes() == getattr(want, name).tobytes(), name
        assert getattr(got, name).dtype == getattr(want, name).dtype, name
    assert (got.n_shards, got.rows_per_shard, got.export_max) == \
        (want.n_shards, want.rows_per_shard, want.export_max)
    arr = rng.normal(0, 1, (n, 3)).astype(np.float32)
    assert partition.apply_plan(got, arr).tobytes() == jpart.apply_plan(want, arr).tobytes()
    laid = partition.apply_plan(got, arr)
    assert partition.unapply_plan(got, laid, n).tobytes() == \
        jpart.unapply_plan(want, laid, n).tobytes()
    np.testing.assert_array_equal(partition.unapply_plan(got, laid, n), arr)
    for n_valid, headroom in ((n, 3.0), (n // 2 + 1, 3.0), (n, 100.0), (1, 1.0)):
        assert partition.export_budget(got, n_valid, headroom) == \
            jpart.export_budget(want, n_valid, headroom)


def test_halo_plan_invariants():
    """Every cross-shard reference points into its owner's export prefix."""
    from repro_torch.graph.structures import coo_to_csr, csr_to_ell_fast

    rng = np.random.default_rng(0)
    src, dst, wgt = random_undirected_coo(rng, 100, 4.0)
    nbr = csr_to_ell_fast(coo_to_csr(100, src, dst, wgt)).nbr.numpy()
    plan = partition.build_halo_plan(nbr, 4)
    m = plan.rows_per_shard
    assert len(plan.perm) % 4 == 0
    owner = np.arange(len(plan.perm)) // m
    rows, lanes = np.nonzero(plan.nbr >= 0)
    v = plan.nbr[rows, lanes]
    cross = owner[v] != owner[rows]
    assert (v[cross] % m < plan.export_max).all()


def test_export_budget_headroom_and_cap():
    nbr = np.full((64, 4), -1, np.int32)
    nbr[:, 0] = (np.arange(64) + 8) % 64  # a ring: every row crosses at +8
    plan = partition.build_halo_plan(nbr, 8)
    assert plan.rows_per_shard == 8
    assert partition.export_budget(plan, 64, headroom=100.0) == 8
    assert partition.export_budget(plan, 32) >= partition.export_budget(plan, 64)


@pytest.mark.parametrize("shards", [3, 8])
def test_apply_halo_layout_bytes_match_reference(shards):
    """The halo-laid-out host snapshot of a kNN stream is the reference's,
    byte for byte, with the row padding a mesh asks for."""
    kw = dict(total_vertices=360, batch_size=120, seed=4, emb_dim=8, class_sep=6.0,
              noise=0.9)
    gt, gj = DynamicGraph(8, k=5), jdyn.DynamicGraph(8, k=5)
    for (tb, _), (jb, _) in zip(gaussian_mixture_stream(StreamSpec(**kw)),
                                jsynth.gaussian_mixture_stream(jsynth.StreamSpec(**kw))):
        gt.apply_batch(tb)
        gj.apply_batch(jb)
    ht = build_host_problem(gt, auto_bucket=True, row_multiple=shards)
    hj = jbuild_host_problem(gj, auto_bucket=True, row_multiple=shards)
    assert ht.bucket_key == hj.bucket_key and ht.bucket_key[0] % shards == 0
    st = apply_halo_layout(ht, partition.build_halo_plan(ht.nbr, shards))
    sj = japply_halo_layout(hj, jpart.build_halo_plan(hj.nbr, shards))
    for name in ("nbr", "wgt", "wl0", "wl1", "valid", "unl_ids", "remap"):
        assert getattr(st, name).tobytes() == getattr(sj, name).tobytes(), name
    with pytest.raises(ValueError, match="halo plan rows"):
        apply_halo_layout(ht, partition.build_halo_plan(ht.nbr[:-shards], shards))


# ---------------------------------------------------------------------- #
# the sharded solve
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("shards", MESHES)
@pytest.mark.parametrize("backend", ["ref", "ell_cuda"])
def test_distributed_propagate_matches(shards, backend):
    """200 rows (not a multiple of 3 or 8: the padding path), every row on
    the frontier: the port's single-device solve bit for bit, the
    reference's within 20·δ."""
    jp, tp = _pair(1, 200)
    f0, fr = torch.full((200,), 0.5), torch.ones(200, dtype=torch.bool)
    mesh = DeviceMesh.local(shards, device="cpu")
    got = dist.distributed_propagate(tp, f0, fr, mesh, delta=DELTA, backend=backend)
    want = propagate(tp, f0, fr, delta=DELTA)
    _same(got, want)
    assert got.converged and got.iterations > 10
    ref = jprop.propagate(jp, jnp.full((200,), 0.5), jnp.ones(200, bool), delta=DELTA)
    assert np.abs(got.f.numpy() - np.asarray(ref.f)).max() <= F_TOL
    assert abs(got.iterations - int(ref.iterations)) <= max(1, 0.05 * got.iterations)


@pytest.mark.parametrize("shards", MESHES)
def test_distributed_propagate_halo_matches(shards):
    """The rows in ``build_halo_plan``'s layout on the halo transport:
    folded back, the port's single-device solve bit for bit; the
    reference's within 20·δ."""
    n = 160
    jp, tp = _pair(5, n)
    plan = partition.build_halo_plan(tp.nbr.numpy(), shards)
    pp = _laid_out(tp, plan)
    n_pad = len(plan.perm)
    fr = torch.from_numpy(partition.apply_plan(plan, np.ones(n, bool)))
    mesh = DeviceMesh.local(shards, device="cpu")
    got = dist.distributed_propagate_halo(pp, torch.full((n_pad,), 0.5), fr, mesh,
                                          export_max=plan.export_max, delta=DELTA)
    want = propagate(tp, torch.full((n,), 0.5), torch.ones(n, dtype=torch.bool), delta=DELTA)
    back = partition.unapply_plan(plan, got.f.numpy(), n)
    assert back.tobytes() == want.f.numpy().tobytes()
    assert (got.iterations, got.converged, got.max_residual) == \
        (want.iterations, want.converged, want.max_residual)
    ref = jprop.propagate(jp, jnp.full((n,), 0.5), jnp.ones(n, bool), delta=DELTA)
    assert np.abs(back - np.asarray(ref.f)).max() <= F_TOL
    # per sweep and per vector (F: 4 bytes, changed: 1): the export
    # prefixes gathered on the one device, then every shard's substitute
    m, e, k = n_pad // shards, plan.export_max, shards
    assert got.transport_bytes == got.iterations * 5 * (k * e + k * (k * e + m))


def test_allgather_bytes_and_frontier_subset():
    """A frontier on a few rows; the all-gather copies N values of F (4
    bytes) and of ``changed`` (1 byte) into the one buffer of the mesh's
    one device, each sweep."""
    _, tp = _pair(2, 256)
    f0 = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, 256).astype(np.float32))
    fr = torch.zeros(256, dtype=torch.bool)
    fr[::37] = True
    mesh = DeviceMesh.local(8, device="cpu")
    got = dist.distributed_propagate(tp, f0, fr, mesh, delta=DELTA)
    _same(got, propagate(tp, f0, fr, delta=DELTA))
    assert got.transport_bytes == got.iterations * 256 * 5
    # an empty frontier runs no sweep and moves nothing
    res = dist.distributed_propagate(tp, f0, torch.zeros(256, dtype=torch.bool), mesh)
    assert (res.iterations, res.converged, res.max_residual, res.transport_bytes) == \
        (0, True, 0.0, 0)
    assert torch.equal(res.f, f0)


def test_halo_substitute_is_per_shard():
    """Shards on one device get a substitute each: own block exact, the
    other shards' export prefixes, zeros elsewhere (a shared buffer would
    hold every block in full and turn halo into all-gather)."""
    mesh = DeviceMesh.local(4, device="cpu")
    m, e = 6, 2
    g = dist._Gather(mesh, m, "halo", e, torch.float32)
    blocks = [torch.arange(1, m + 1, dtype=torch.float32) + 10 * s for s in range(4)]
    views = g(blocks)
    assert len({v.data_ptr() for v in views}) == 4
    for s, v in enumerate(views):
        want = torch.zeros(4 * m)
        for t in range(4):
            want[t * m:t * m + e] = blocks[t][:e]
        want[s * m:(s + 1) * m] = blocks[s]
        assert torch.equal(v, want), s
    assert g.bytes == (4 * e) * 4 + 4 * (4 * e + m) * 4  # one device: one export gather
    ga = dist._Gather(mesh, m, "allgather", None, torch.float32)
    views = ga(blocks)
    assert len({v.data_ptr() for v in views}) == 1
    assert torch.equal(views[0], torch.cat(blocks)) and ga.bytes == 4 * m * 4


def test_mesh_bsr_backend_and_its_slot_map():
    """bsr on a mesh solves through the sharded SpMV body given the slot
    map, within 2e-3 of ``propagate`` (the reference's bound between bsr
    and ref), the same bits under both transports; without the map it is
    refused."""
    jp, tp = _pair(0, 64)
    f0, fr = torch.full((64,), 0.5), torch.ones(64, dtype=torch.bool)
    bs = ops.bsr_block_size("cpu")
    layout = ell_bsr_layout(tp.nbr.numpy(), bs)
    mesh = DeviceMesh.local(2, device="cpu")
    res = ops.run_propagation(tp, f0, fr, backend="bsr", mesh=mesh, slot=layout.slot,
                              num_slots=layout.num_slots, device="cpu")
    want = propagate(tp, f0, fr)
    assert np.abs(res.f.numpy() - want.f.numpy()).max() <= 2e-3
    plan = partition.build_halo_plan(tp.nbr.numpy(), 2)
    halo = ops.run_propagation(tp, f0, fr, backend="bsr", mesh=mesh, slot=layout.slot,
                               num_slots=layout.num_slots, transport="halo",
                               export_max=plan.rows_per_shard)
    assert halo.f.numpy().tobytes() == res.f.numpy().tobytes()
    with pytest.raises(ValueError, match="slot"):
        ops.run_propagation(tp, f0, fr, backend="bsr", mesh=mesh)


def test_run_propagation_transport_validation():
    _, tp = _pair(0, 64)
    f0, fr = torch.full((64,), 0.5), torch.ones(64, dtype=torch.bool)
    mesh = DeviceMesh.local(1, device="cpu")
    with pytest.raises(ValueError, match="unknown transport"):
        ops.run_propagation(tp, f0, fr, transport="ring", device="cpu")
    with pytest.raises(ValueError, match="needs mesh"):
        ops.run_propagation(tp, f0, fr, transport="halo", device="cpu")
    with pytest.raises(ValueError, match="needs export_max"):
        ops.run_propagation(tp, f0, fr, transport="halo", mesh=mesh)
    plan = dist.build_stream_plan(mesh, (64, tp.nbr.shape[1]))
    with pytest.raises(ValueError, match="shard_plan mismatch"):
        ops.run_propagation(tp, f0, fr, shard_plan=plan, transport="halo")
    # a bucket that does not divide the mesh is refused at planning time
    with pytest.raises(ValueError, match="row_multiple"):
        dist.build_stream_plan(DeviceMesh.local(8, device="cpu"), (257, 8))
    with pytest.raises(ValueError, match="block_size"):
        dist.build_stream_plan(DeviceMesh.local(2, device="cpu"), (24, 8), backend="bsr",
                               block_size=8, num_slots=1)
    # the plan's run refuses a problem of another rung
    res = ops.run_propagation(tp, f0, fr, mesh=mesh, backend="ref")
    _same(res, propagate(tp, f0, fr))
    with pytest.raises(ValueError, match="does not match plan rung"):
        plan(plan.put_problem(*(getattr(tp, k)[:32] for k in
                                ("nbr", "wgt", "wl0", "wl1", "valid"))),
             plan.put_row(f0[:32]), plan.put_row(fr[:32]))


def test_plans_are_memoized_per_rung():
    mesh = DeviceMesh.local(4, device="cpu")
    before = dist.plan_count()
    a = dist.build_stream_plan(mesh, (64, 8), delta=1e-3)
    assert dist.build_stream_plan(DeviceMesh.local(4, device="cpu"), (64, 8), delta=1e-3) is a
    h = dist.build_stream_halo_plan(mesh, (64, 8), 5, delta=1e-3)
    assert h.export_max == 5 and h.transport == "halo" and a.transport == "allgather"
    assert dist.build_stream_halo_plan(mesh, (64, 8), 100, delta=1e-3).export_max == 16
    assert dist.plan_count() == before + 3


def test_pad_problem():
    _, tp = _pair(3, 50)
    sp = dist.pad_problem(tp, 8)
    assert sp.n_orig == 50 and sp.problem.num_unlabeled == 56
    assert (sp.problem.nbr[50:] == -1).all() and not sp.problem.valid[50:].any()
    assert torch.equal(sp.problem.wgt[:50], tp.wgt)
    assert dist.pad_problem(tp, 5).problem is tp


def test_device_mesh():
    mesh = DeviceMesh.local(8, device="cpu")
    assert mesh.n_devices == 8 and mesh.device == torch.device("cpu")
    assert mesh.distinct == (torch.device("cpu"),)
    assert mesh == DeviceMesh(["cpu"] * 8) and hash(mesh) == hash(DeviceMesh(["cpu"] * 8))
    assert mesh != DeviceMesh.local(4, device="cpu")
    with pytest.raises(ValueError, match="at least one shard"):
        DeviceMesh.local(0, device="cpu")
    with pytest.raises(ValueError, match="at least one shard"):
        DeviceMesh([])
    # the read placement of a mesh with no spare card: its sharded view,
    # which on one device is that device's one view
    assert dist.read_replica_device(mesh) is None
    assert dist.view_sharding(mesh).devices == (torch.device("cpu"),)
    assert dist.read_placement(mesh) == dist.view_sharding(mesh)
    assert dist.read_placement(None) is None


def test_device_mesh_needs_a_card_by_default():
    """Without a device, a mesh means the card, and there is none here."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceMesh.local(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceMesh.visible()


def test_shard_rows_copies_each_block():
    mesh = DeviceMesh.local(4, device="cpu")
    x = np.arange(12, dtype=np.float32)
    parts = dist.shard_rows(mesh, x)
    assert [p.tolist() for p in parts] == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11]]
    x[:] = -1  # the shards own their tensors
    assert parts[0][0] == 0
    with pytest.raises(ValueError, match="do not split"):
        dist.shard_rows(mesh, np.zeros(10))
    p = dist.shard_problem(mesh, *(np.zeros((8, 2), np.int32), np.zeros((8, 2), np.float32),
                                   np.zeros(8, np.float32), np.zeros(8, np.float32),
                                   np.ones(8, bool)))
    assert isinstance(p.shards[0], PropagationProblem)
    assert p.shape == (8, 2) and p.rows_per_shard == 2
