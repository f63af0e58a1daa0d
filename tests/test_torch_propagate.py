"""Port vs reference, the propagation engines and the backend registry.

Tolerances: F within 20·δ of the reference (XLA and the port add the K
lanes in different orders, so the fixpoints differ by rounding that the δ
stopping rule can stretch; the reference holds its own backends to the same
bound, ``benchmarks/stream_throughput.py`` ``BACKEND_MAX_ABS_DIFF``) and
iteration counts within 5% (a row whose residual straddles δ by one ULP
can add or drop a sweep).  Inside the port the two backends give the same
bits and the same sweep count.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import propagate as tprop
from repro_torch.graph.structures import PAD
from repro_torch.kernels import ops
from repro_torch.state import problem_from_arrays

from helpers import random_problem

# the package re-exports a function named ``propagate``; take the module
jprop = importlib.import_module("repro.core.propagate")

torch.set_num_threads(1)

DELTA = 1e-4
F_TOL = 20 * DELTA
UPDATE_TOL = 1e-6  # one update: a few f32 ULPs of values in [0, 1]


def _pair(seed, n, avg_deg=4.0):
    """The same random problem for both packages (built by the test helper
    on the JAX side, handed over as numpy arrays)."""
    jp = random_problem(np.random.default_rng(seed), n, 2, avg_deg)
    tp = problem_from_arrays(*(np.asarray(a) for a in jp), device="cpu")
    return jp, tp


def _iters_close(a, b):
    assert abs(a - b) <= max(1, 0.05 * max(a, b)), (a, b)


@pytest.mark.parametrize("seed,n", [(0, 40), (1, 120), (2, 300)])
def test_lp_update_matches(seed, n):
    jp, tp = _pair(seed, n)
    f = np.random.default_rng(seed).uniform(0, 1, n).astype(np.float32)
    got = tprop.lp_update(tp, torch.from_numpy(f))
    want = jprop.lp_update(jp, jnp.asarray(f))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=UPDATE_TOL)
    np.testing.assert_allclose(
        tp.wall().numpy(), np.asarray(jp.wall()), rtol=0, atol=UPDATE_TOL)


@pytest.mark.parametrize("seed,n,frontier_p", [(3, 100, 1.0), (4, 250, 0.2), (5, 400, 0.05)])
def test_propagate_matches(seed, n, frontier_p):
    jp, tp = _pair(seed, n)
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(0, 1, n).astype(np.float32)
    fr = rng.random(n) < frontier_p
    want = jprop.propagate(jp, jnp.asarray(f0), jnp.asarray(fr), delta=DELTA,
                           max_iters=20_000)
    got = tprop.propagate(tp, torch.from_numpy(f0), torch.from_numpy(fr),
                          delta=DELTA, max_iters=20_000)
    np.testing.assert_allclose(got.f.numpy(), np.asarray(want.f), rtol=0, atol=F_TOL)
    _iters_close(got.iterations, int(want.iterations))
    assert got.converged == bool(want.converged)
    assert abs(got.max_residual - float(want.max_residual)) <= DELTA


@pytest.mark.parametrize("seed,n", [(6, 80), (7, 200)])
def test_propagate_full_and_residual_match(seed, n):
    jp, tp = _pair(seed, n)
    f0 = np.full(n, 0.5, np.float32)
    want = jprop.propagate_full(jp, jnp.asarray(f0), delta=DELTA, max_iters=50_000)
    got = tprop.propagate_full(tp, torch.from_numpy(f0), delta=DELTA, max_iters=50_000)
    np.testing.assert_allclose(got.f.numpy(), np.asarray(want.f), rtol=0, atol=F_TOL)
    _iters_close(got.iterations, int(want.iterations))
    assert got.converged and bool(want.converged)
    r_t = float(tprop.harmonic_residual(tp, got.f))
    r_j = float(jprop.harmonic_residual(jp, want.f))
    assert r_t <= DELTA and r_j <= DELTA
    assert abs(r_t - r_j) <= UPDATE_TOL


@pytest.mark.parametrize("seed,n", [(8, 150), (9, 333)])
def test_backends_give_the_same_bits(seed, n):
    """ref and ell_cuda (its plain version on the CPU) run the same
    arithmetic in the same order: equal labels and sweep counts."""
    _, tp = _pair(seed, n)
    rng = np.random.default_rng(seed)
    f0 = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
    fr = torch.from_numpy(rng.random(n) < 0.3)
    a = ops.run_propagation(tp, f0, fr, delta=DELTA, backend="ref", device="cpu")
    b = ops.run_propagation(tp, f0, fr, delta=DELTA, backend="ell_cuda", device="cpu")
    assert torch.equal(a.f, b.f)
    assert (a.iterations, a.converged, a.max_residual) == \
        (b.iterations, b.converged, b.max_residual)


def test_padding_rows_inert():
    _, p = _pair(0, 8)
    pad = lambda t, v: torch.cat([t, torch.full((4,) + t.shape[1:], v, dtype=t.dtype)])  # noqa: E731
    padded = tprop.PropagationProblem(nbr=pad(p.nbr, PAD), wgt=pad(p.wgt, 0.0),
                                      wl0=pad(p.wl0, 0.0), wl1=pad(p.wl1, 0.0),
                                      valid=pad(p.valid, False))
    for backend in ("ref", "ell_cuda"):
        res = ops.run_propagation(padded, torch.full((12,), 0.5), torch.ones(12, dtype=torch.bool),
                                  delta=1e-6, backend=backend, device="cpu")
        base = ops.run_propagation(p, torch.full((8,), 0.5), torch.ones(8, dtype=torch.bool),
                                   delta=1e-6, backend=backend, device="cpu")
        assert torch.equal(res.f[:8], base.f)
        assert torch.equal(res.f[8:], torch.full((4,), 0.5))


def test_frontier_localized_change_stays_local():
    """Chain with a strong anchor at the head and a large δ: the frontier
    dies before the tail, which keeps its label (mirrors the reference)."""
    n = 6
    nbr = np.full((n, 2), PAD, np.int32)
    wgt = np.zeros((n, 2), np.float32)
    for i in range(n - 1):
        nbr[i, 1], nbr[i + 1, 0] = i + 1, i
        wgt[i, 1] = wgt[i + 1, 0] = 1.0
    wl0 = np.zeros(n, np.float32)
    wl0[0] = 10.0
    p = problem_from_arrays(nbr, wgt, wl0, np.zeros(n, np.float32),
                            np.ones(n, bool), device="cpu")
    frontier = torch.zeros(n, dtype=torch.bool)
    frontier[0] = True
    for backend in ("ref", "ell_cuda"):
        res = ops.run_propagation(p, torch.full((n,), 0.9), frontier, delta=0.2,
                                  max_iters=100, backend=backend, device="cpu")
        assert res.f[0] < 0.2 and res.f[-1] == pytest.approx(0.9) and res.converged


def test_max_iters_stops_unconverged():
    _, tp = _pair(10, 200)
    res = ops.run_propagation(tp, torch.full((200,), 0.5), torch.ones(200, dtype=torch.bool),
                              delta=1e-9, max_iters=3, backend="ell_cuda", device="cpu")
    assert res.iterations == 3 and not res.converged and res.max_residual > 0


def test_registry_auto_selection():
    """auto: ell_cuda on a CUDA device at every size, ref on the CPU; the
    names are the port's own."""
    assert ops.backend_names() == ("ref", "ell_cuda")
    for hw, want in (("cuda", "ell_cuda"), ("cpu", "ref")):
        info = ops.ProblemInfo(device_type=hw)
        assert [n for n in ops.backend_names() if ops.backend_spec(n).auto_eligible(info)] \
            == (["ref", "ell_cuda"] if hw == "cuda" else ["ref"])
        for auto in (None, "auto"):
            assert ops.select_backend(auto, device=hw) == want
    assert ops.select_backend("ref", device="cuda") == "ref"
    for rows in (1, 256, 2000):  # every size: the problem's rows do not matter
        _, tp = _pair(0, rows)
        assert ops.select_backend(None, tp) == "ref"  # the problem lies on the CPU
        assert ops.select_backend(None, tp, device="cuda") == "ell_cuda"
    with pytest.raises(ValueError, match="unknown backend"):
        ops.select_backend("ell_pallas", device="cuda")


def test_env_backend_hint_is_not_read(monkeypatch):
    monkeypatch.setenv("REPRO_BACKEND", "ell_pallas")
    assert ops.select_backend(None, device="cpu") == "ref"
    assert ops.select_backend(None, device="cuda") == "ell_cuda"


def test_run_propagation_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    _, tp = _pair(0, 20)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.run_propagation(tp, torch.full((20,), 0.5), torch.ones(20, dtype=torch.bool))
