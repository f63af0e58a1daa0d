"""The port's Shiloach–Vishkin hook step against the JAX package's, on the CPU.

Mirrors the ``cc_hook`` cases of ``tests/test_kernels.py``.  The JAX side
runs its Pallas kernel in interpret mode.  Labels are exact integers, so
the step, the fixpoint labels and the iteration counts must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.structures import coo_to_csr, csr_to_ell_fast
from repro.kernels import cc_hook as jcc
from repro.kernels import ref as jref
from repro_torch.core.components import connected_components, host_components
from repro_torch.kernels.cc_hook import cc_hook_ref, cc_hook_step, connected_components_cuda

from helpers import random_undirected_coo, union_find_components

torch.set_num_threads(1)


def _ell(rng, n, avg_deg):
    src, dst, wgt = random_undirected_coo(rng, n, avg_deg)
    return np.array(csr_to_ell_fast(coo_to_csr(n, src, dst, wgt)).nbr), src, dst


@pytest.mark.parametrize("n,k", [(64, 3), (256, 5), (128, 1)])
def test_hook_step_matches_reference(n, k):
    rng = np.random.default_rng(n + k)
    nbr, _, _ = _ell(rng, n, float(k))
    par = rng.permutation(n).astype(np.int32)
    got = cc_hook_ref(torch.from_numpy(nbr), torch.from_numpy(par))
    assert got.dtype == torch.int32 and got.shape == (n,)
    for want in (jcc.cc_hook_step(jnp.asarray(nbr), jnp.asarray(par), block_rows=min(64, n)),
                 jref.cc_hook_ref(jnp.asarray(nbr), jnp.asarray(par))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,k,pad", [(100, 4, 0.3), (50, 7, 1.0), (33, 2, 0.0)])
def test_hook_step_on_random_ell_matches_reference(n, k, pad):
    """Directed random lanes with padding (the kernel never reads a -1
    lane): the plain version and the wrapper equal the reference's step."""
    rng = np.random.default_rng(n * k)
    nbr = rng.integers(0, n, size=(n, k)).astype(np.int32)
    nbr[rng.random((n, k)) < pad] = -1
    par = rng.integers(0, n, n).astype(np.int32)
    want = np.asarray(jref.cc_hook_ref(jnp.asarray(nbr), jnp.asarray(par)))
    before = cc_hook_step.launches
    got = cc_hook_step(torch.from_numpy(nbr), torch.from_numpy(par))
    assert cc_hook_step.launches == before  # a launch is counted on the card only
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,avg_deg,seed", [(256, 2.0, 3), (320, 1.0, 4), (64, 6.0, 5)])
def test_fixpoint_matches_reference_and_union_find(n, avg_deg, seed):
    """``connected_components_cuda`` against ``connected_components_pallas``:
    the same labels and the same iteration count; the labels equal
    union-find's and the port's other two component routines'."""
    rng = np.random.default_rng(seed)
    nbr, src, dst = _ell(rng, n, avg_deg)
    par, iters = connected_components_cuda(torch.from_numpy(nbr))
    jpar, jiters = jcc.connected_components_pallas(jnp.asarray(nbr), block_rows=min(64, n))
    np.testing.assert_array_equal(par.numpy(), np.asarray(jpar))
    assert iters == int(jiters)
    want = union_find_components(n, src, dst)
    np.testing.assert_array_equal(par.numpy(), want)
    np.testing.assert_array_equal(host_components(nbr), want)
    np.testing.assert_array_equal(connected_components(torch.from_numpy(nbr)).labels.numpy(),
                                  want)


def test_fixpoint_edge_cases():
    # no edges: every vertex its own component, settled in one step
    par, iters = connected_components_cuda(torch.full((5, 2), -1, dtype=torch.int32))
    assert par.tolist() == [0, 1, 2, 3, 4] and iters == 1
    # a path 0-1-2-...-9 needs several steps; max_iters caps them
    n = 10
    nbr = np.full((n, 2), -1, np.int32)
    nbr[1:, 0] = np.arange(n - 1)
    nbr[:-1, 1] = np.arange(1, n)
    par, iters = connected_components_cuda(torch.from_numpy(nbr))
    jpar, jiters = jcc.connected_components_pallas(jnp.asarray(nbr), block_rows=n)
    assert (par == 0).all() and iters == int(jiters) > 2
    capped, capped_iters = connected_components_cuda(torch.from_numpy(nbr), max_iters=2)
    assert capped_iters == 2 and not (capped == 0).all()


@pytest.mark.parametrize("bad,exc,match", [
    (lambda nbr, par: (nbr[0], par), ValueError, r"\(N, K\)"),
    (lambda nbr, par: (nbr.long(), par), TypeError, "int32"),
    (lambda nbr, par: (nbr, par.long()), TypeError, "int32"),
    (lambda nbr, par: (nbr, par[:-1]), ValueError, "shape"),
    (lambda nbr, par: (nbr.t().contiguous().t(), par), ValueError, "contiguous"),
])
def test_hook_step_checks_its_inputs(bad, exc, match):
    nbr = torch.zeros((6, 3), dtype=torch.int32)
    par = torch.arange(6, dtype=torch.int32)
    with pytest.raises(exc, match=match):
        cc_hook_step(*bad(nbr, par))
