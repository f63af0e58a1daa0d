"""The plain reference against brute force on tiny corpora."""

import numpy as np
import pytest
import torch

from portbench.reference import knn as rk
from portbench.reference import propagation as rp


def _corpus(n, d=16, seed=0, dup=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if dup:  # exact duplicates: ties the order has to break by id
        x[1:dup + 1] = x[0]
    return x


def _brute(x, k):
    xh = rk.normalize_rows(x)
    w = rk.canonical_weights(xh[:, None, :], xh[None, :, :])
    np.fill_diagonal(w, -np.inf)
    ids = np.broadcast_to(np.arange(len(x)), w.shape)
    order = np.lexsort((ids, -w), axis=-1)[:, :k]
    return order, np.take_along_axis(w, order, 1)


@pytest.mark.parametrize("n,k,dup,d", [(300, 5, 0, 16), (257, 3, 0, 16), (200, 5, 12, 16),
                                       (300, 5, 0, 128)])
def test_exact_knn_is_brute_force(n, k, dup, d):
    x = _corpus(n, d=d, seed=n, dup=dup)
    got = rk.exact_knn(x, k)
    idx, wgt = _brute(x, k)
    assert np.array_equal(got.idx, idx)
    assert np.array_equal(got.wgt, wgt)


def test_widening_finds_what_the_first_pass_missed(monkeypatch):
    x = _corpus(150, seed=3)
    monkeypatch.setattr(rk, "MARGIN", 0)  # t = k: every row needs the wider pass
    monkeypatch.setattr(rk, "COS_SLACK", 1.0)
    got = rk.exact_knn(x, 4)
    idx, wgt = _brute(x, 4)
    assert got.widened == 150
    assert np.array_equal(got.idx, idx) and np.array_equal(got.wgt, wgt)


def test_tf32_rounding():
    v = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.14159265], dtype=torch.float32)
    r = rk.round_tf32(v)
    assert r[0] == 1.0 and r[1] == 1.0  # a tie rounds to even
    assert r[2] == 1.0 + 2**-10 + 2**-10 or r[2] == 1.0 + 2**-10
    mant = r.view(torch.int32) & 0x1FFF
    assert (mant == 0).all()
    assert (r - v).abs().max() <= 2**-11 * v.abs().max()


def _dense_fixed_point(p: rp.Problem):
    """The supernode system solved directly: (D - W) F = wl1."""
    u = len(p.wl0)
    a = np.zeros((u, u))
    for r in range(u):
        for c, w in zip(p.nbr[r], p.wgt[r]):
            if c >= 0:
                a[r, c] -= w
        a[r, r] += p.wgt[r].sum() + p.wl0[r] + p.wl1[r]
    return np.linalg.solve(a, p.wl1)


@pytest.mark.parametrize("max_k", [None, 4])
def test_fixed_point_is_the_linear_solve(max_k):
    x = _corpus(220, seed=9)
    res = rk.exact_knn(x, 5)
    labels = np.full(220, rp.UNLABELED, np.int8)
    labels[:12] = np.arange(12) % 2
    p = rp.build_problem(res.idx, res.wgt, labels, max_k)
    if max_k is not None:
        assert p.nbr.shape[1] == max_k
    sol = rp.fixed_point(p)
    assert sol.determined.all()
    assert np.abs(sol.f - _dense_fixed_point(p)).max() < 1e-9


def test_problem_truncates_to_the_heaviest_and_folds_seeds():
    # a star: 0 is everyone's neighbour; 1 and 2 are seeds
    idx = np.array([[1, 2, 3, 4], [0, 2, 3, 4], [0, 1, 3, 4], [0, 1, 2, 4], [0, 1, 2, 3]])
    w = np.array([[.9, .8, .7, .6]] * 5, np.float32)
    labels = np.array([-1, 0, 1, -1, -1], np.int8)
    p = rp.build_problem(idx, w, labels, max_k=1)
    assert list(p.unl_ids) == [0, 3, 4]
    # row 0's unlabeled neighbours 3 (0.7) and 4 (0.6): the heavier kept
    assert p.nbr[0].tolist() == [1] and p.wgt[0, 0] == pytest.approx(0.7)
    # labeled neighbours fold into wl0 (vertex 1) and wl1 (vertex 2)
    assert p.wl0[0] == pytest.approx(0.9) and p.wl1[0] == pytest.approx(0.8)


def test_seedless_component_is_undetermined():
    idx = np.array([[1], [0], [3], [2]])
    w = np.full((4, 1), 0.9, np.float32)
    labels = np.array([1, -1, -1, -1], np.int8)
    p = rp.build_problem(idx, w, labels, None)
    sol = rp.fixed_point(p)
    assert sol.determined.tolist() == [True, False, False]
    assert sol.f[0] == pytest.approx(1.0)


def test_bfloat16_fixed_point_stops():
    x = _corpus(200, seed=4)
    res = rk.exact_knn(x, 5)
    labels = np.full(200, rp.UNLABELED, np.int8)
    labels[:10] = np.arange(10) % 2
    p = rp.build_problem(res.idx, res.wgt, labels, 20)
    low = rp.fixed_point(p, dtype=torch.bfloat16, max_iters=5000)
    assert low.iterations < 5000
    f = torch.from_numpy(low.f)
    assert torch.equal(f.to(torch.bfloat16).to(torch.float64), f)
