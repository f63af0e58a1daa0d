"""Port vs reference: G′ components, label compaction and supernode init.

Component labels are exact integers, so they must be equal.  The supernode
init sums weights per component (``index_add_`` vs XLA's ``segment_sum``,
which may add in another order), so it is held within 1e-6: a few float32
ULPs of values in [0, 1].
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dynlp as jdynlp
from repro.graph import dynamic as jdyn
from repro.graph.structures import coo_to_csr as j_coo_to_csr, csr_to_ell_fast as j_csr_to_ell
from repro_torch.core import components as tcc
from repro_torch.core import dynlp as tdynlp
from repro_torch.core.init_labels import supernode_init
from repro_torch.graph import dynamic as tdyn
from repro_torch.graph.structures import coo_to_csr, csr_to_ell_fast

from helpers import random_undirected_coo, union_find_components

torch.set_num_threads(1)

# the package re-exports functions named like these modules; take the modules
jcc = importlib.import_module("repro.core.components")
jinit = importlib.import_module("repro.core.init_labels")

INIT_TOL = 1e-6  # per-component sums may be added in another order


def _ell(seed, n, avg_deg):
    src, dst, wgt = random_undirected_coo(np.random.default_rng(seed), n, avg_deg)
    return src, dst, wgt, csr_to_ell_fast(coo_to_csr(n, src, dst, wgt))


@pytest.mark.parametrize("seed,n,avg_deg,tau", [
    (0, 2, 0.5, None), (1, 37, 1.5, None), (2, 60, 4.0, None), (3, 200, 2.5, None),
    (4, 40, 3.0, 0.55), (5, 150, 5.0, 0.8), (6, 500, 1.2, None),
])
def test_connected_components_exact(seed, n, avg_deg, tau):
    src, dst, wgt, ell = _ell(seed, n, avg_deg)
    got = tcc.connected_components(ell.nbr, None if tau is None else ell.wgt,
                                   tau=tau or 0.0)
    want = jcc.connected_components(jnp.asarray(ell.nbr.numpy()),
                                    None if tau is None else jnp.asarray(ell.wgt.numpy()),
                                    tau=tau or 0.0)
    assert got.labels.dtype == torch.int32
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert got.iterations == int(want.iterations)
    keep = np.ones(len(src), bool) if tau is None else wgt > tau
    np.testing.assert_array_equal(got.labels.numpy(),
                                  union_find_components(n, src[keep], dst[keep]))


def test_components_of_empty_graph_and_two_cliques():
    nbr = torch.full((4, 2), -1, dtype=torch.int32)
    np.testing.assert_array_equal(tcc.connected_components(nbr).labels.numpy(), np.arange(4))
    src = np.array([0, 1, 1, 2, 0, 2, 3, 4], np.int64)
    dst = np.array([1, 0, 2, 1, 2, 0, 4, 3], np.int64)
    ell = csr_to_ell_fast(coo_to_csr(6, src, dst, np.ones(8, np.float32)))
    labels = tcc.connected_components(ell.nbr).labels
    np.testing.assert_array_equal(labels.numpy(), [0, 0, 0, 3, 3, 5])
    assert int(tcc.num_components(labels)) == 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_labels_exact(seed):
    _, _, _, ell = _ell(seed, 120, 1.0)
    labels = tcc.connected_components(ell.nbr).labels
    got = tcc.compact_labels(labels)
    want = jcc.compact_labels(jnp.asarray(labels.numpy()))
    assert got.dtype == torch.int32  # the prefix scan stays int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(tcc.num_components(labels)) == int(jcc.num_components(jnp.asarray(labels.numpy())))


def test_host_passes_match():
    _, _, _, ell = _ell(7, 90, 2.0)
    nbr = ell.nbr.numpy()
    np.testing.assert_array_equal(tcc.host_components(nbr), jcc.host_components(nbr))
    order = tcc.component_order(nbr)
    np.testing.assert_array_equal(order, jcc.component_order(nbr))
    for a, b in zip(tcc.permute_ell_rows(nbr, order), jcc.permute_ell_rows(nbr, order)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed,m,segments", [(0, 50, 10), (1, 400, 37), (2, 1000, 1000)])
def test_supernode_init_matches(seed, m, segments):
    rng = np.random.default_rng(seed)
    comp = rng.integers(0, segments, m).astype(np.int32)
    w0 = (rng.uniform(0, 1, m) * (rng.random(m) < 0.5)).astype(np.float32)
    w1 = (rng.uniform(0, 1, m) * (rng.random(m) < 0.5)).astype(np.float32)
    got = supernode_init(torch.from_numpy(comp), torch.from_numpy(w0),
                         torch.from_numpy(w1), num_segments=segments)
    want = jinit.supernode_init(jnp.asarray(comp), jnp.asarray(w0), jnp.asarray(w1),
                                num_segments=segments)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=INIT_TOL)
    # components with no label weight start at 0.5
    empty = np.bincount(comp, weights=w0 + w1, minlength=segments) == 0
    assert (got.numpy()[empty[comp]] == 0.5).all()
    assert not torch.are_deterministic_algorithms_enabled()  # restored


def test_gprime_components_match():
    """G′ of a real batch: the same component labels in both packages."""
    rng = np.random.default_rng(4)
    emb = rng.normal(0, 1, (300, 6)).astype(np.float32)
    labels = np.full(300, -1, np.int8)
    labels[:3] = [0, 1, 0]
    kw = dict(ins_emb=emb, ins_labels=labels, del_ids=np.zeros(0, np.int64))
    je = jdyn.DynamicGraph(6, 5).apply_batch(jdyn.BatchUpdate(**kw))
    te = tdyn.DynamicGraph(6, 5).apply_batch(tdyn.BatchUpdate(**kw))
    got = tdynlp.gprime_components(te, 300, torch.device("cpu"))
    want = jdynlp.gprime_components(je, 300)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(got.numpy())) > 1
    none = tdyn.BatchEffect(new_ids=np.arange(5), affected=np.arange(5),
                            gprime_src=np.zeros(0, np.int64),
                            gprime_dst=np.zeros(0, np.int64),
                            gprime_wgt=np.zeros(0, np.float32))
    np.testing.assert_array_equal(
        tdynlp.gprime_components(none, 5, torch.device("cpu")).numpy(), np.arange(5))
    # the reference helpers build the same ELL from the same COO
    s = np.concatenate([je.gprime_src, je.gprime_dst])
    d = np.concatenate([je.gprime_dst, je.gprime_src])
    w = np.concatenate([je.gprime_wgt, je.gprime_wgt])
    assert np.asarray(j_csr_to_ell(j_coo_to_csr(300, s, d, w)).nbr).tobytes() == \
        csr_to_ell_fast(coo_to_csr(300, s, d, w)).nbr.numpy().tobytes()
