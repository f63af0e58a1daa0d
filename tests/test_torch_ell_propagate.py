"""Port vs reference, the frontier-sweep kernel module.

On the CPU the port's wrapper runs its plain version, which is held against
the JAX Pallas kernel (interpret mode) and the JAX oracle within 1e-6: the
two packages sum the K lanes in different orders (XLA's reduction vs column
order), so F′ may differ by a few float32 ULPs of values in [0, 1]; the
``changed`` flags must be equal.  The CUDA kernel itself only runs on the
card: ``tests/test_torch_cuda.py`` holds it to the plain version's bits.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ell_propagate import ell_propagate_step as jax_step
from repro_torch.kernels import _build
from repro_torch.kernels.ell_propagate import ell_propagate_ref, ell_propagate_step

torch.set_num_threads(1)

F_TOL = 1e-6  # a few f32 ULPs: the packages sum the K lanes in different orders


def _inputs(rng, n, k, nf=None):
    nf = n if nf is None else nf
    nbr = rng.integers(-1, nf, size=(n, k)).astype(np.int32)
    wgt = (rng.uniform(0.1, 1.0, (n, k)) * (nbr >= 0)).astype(np.float32)
    wl0 = (rng.uniform(0, 1, n) * (rng.random(n) < 0.3)).astype(np.float32)
    wl1 = (rng.uniform(0, 1, n) * (rng.random(n) < 0.3)).astype(np.float32)
    frontier = rng.random(n) < 0.6
    f = rng.uniform(0, 1, nf).astype(np.float32)
    return nbr, wgt, wl0, wl1, frontier, f


def _torch(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("n,k,block_rows", [
    (64, 4, 16), (128, 8, 32), (256, 3, 256), (512, 16, 128), (96, 1, 32),
])
def test_plain_version_matches_pallas_and_oracle(n, k, block_rows):
    rng = np.random.default_rng(n * k)
    arrays = _inputs(rng, n, k)
    got_f, got_ch = ell_propagate_step(*_torch(arrays), delta=1e-3)
    for want_f, want_ch in (
            jax_step(*map(jnp.asarray, arrays), delta=1e-3, block_rows=block_rows,
                     interpret=True),
            jref.ell_propagate_ref(*map(jnp.asarray, arrays), delta=1e-3)):
        np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                                   rtol=0, atol=F_TOL)
        np.testing.assert_array_equal(got_ch.numpy(), np.asarray(want_ch))


@pytest.mark.parametrize("n,nf,row_offset", [(64, 200, 100), (64, 120, 100)])
def test_row_offset_matches_pallas(n, nf, row_offset):
    """A row block indexing a longer global F; the second case runs past
    its end, where both clamp the row to Nf − 1."""
    rng = np.random.default_rng(nf)
    arrays = _inputs(rng, n, 5, nf=nf)
    got_f, got_ch = ell_propagate_step(*_torch(arrays), delta=1e-3,
                                       row_offset=row_offset)
    want_f, want_ch = jax_step(*map(jnp.asarray, arrays), delta=1e-3,
                               block_rows=32, interpret=True,
                               row_offset=row_offset)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0, atol=F_TOL)
    np.testing.assert_array_equal(got_ch.numpy(), np.asarray(want_ch))


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(3)
    args = _torch(_inputs(rng, 300, 7))
    before = ell_propagate_step.launches
    got = ell_propagate_step(*args, delta=1e-4)
    want = ell_propagate_ref(*args, delta=1e-4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].dtype == torch.bool
    assert ell_propagate_step.launches == before


def test_edge_rows():
    """All-PAD rows with Wall == 0 keep F; off-frontier rows keep F and are
    never ``changed``; an all-PAD row with label weight moves to its
    supernode average in one step."""
    nbr = torch.tensor([[-1, -1], [-1, -1], [0, -1]], dtype=torch.int32)
    wgt = torch.tensor([[0, 0], [0, 0], [1, 0]], dtype=torch.float32)
    wl0 = torch.tensor([0, 3, 0], dtype=torch.float32)
    wl1 = torch.tensor([0, 1, 0], dtype=torch.float32)
    frontier = torch.tensor([True, True, False])
    f = torch.tensor([0.3, 0.9, 0.7], dtype=torch.float32)
    f_new, changed = ell_propagate_step(nbr, wgt, wl0, wl1, frontier, f)
    assert f_new.tolist() == pytest.approx([0.3, 0.25, 0.7])
    assert changed.tolist() == [False, True, False]


@pytest.mark.parametrize("bad,exc", [
    ("nbr_dtype", TypeError), ("wgt_shape", ValueError), ("noncontig", ValueError),
    ("frontier_dtype", TypeError), ("f_2d", TypeError), ("device_mix", ValueError),
    ("meta_device", ValueError), ("neg_offset", ValueError), ("empty_f", ValueError),
])
def test_wrapper_rejects_bad_inputs(bad, exc):
    rng = np.random.default_rng(0)
    nbr, wgt, wl0, wl1, frontier, f = _torch(_inputs(rng, 16, 4))
    kw = {}
    if bad == "nbr_dtype":
        nbr = nbr.long()
    elif bad == "wgt_shape":
        wgt = wgt[:, :3].contiguous()
    elif bad == "noncontig":
        wgt = wgt.t().contiguous().t()
    elif bad == "frontier_dtype":
        frontier = frontier.to(torch.uint8)
    elif bad == "f_2d":
        f = f[:, None]
    elif bad == "device_mix":
        wl0 = wl0.to("meta")
    elif bad == "meta_device":
        nbr, wgt, wl0, wl1, frontier, f = (t.to("meta") for t in
                                           (nbr, wgt, wl0, wl1, frontier, f))
    elif bad == "neg_offset":
        kw["row_offset"] = -1
    elif bad == "empty_f":
        f = f[:0]
    with pytest.raises(exc):
        ell_propagate_step(nbr, wgt, wl0, wl1, frontier, f, **kw)


def test_build_needs_nvcc_only_at_first_launch(monkeypatch):
    """The module imports here without nvcc; asking for the library without
    nvcc raises instead of falling back."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "absent-for-test")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_inputs_are_declared():
    assert [p.name for p in _build.sources()] == ["argkmin.cu", "bsr_spmv.cu", "cc_hook.cu",
                                                  "ell_propagate.cu"]
    text = "".join(p.read_text() for p in _build.sources())
    for name in _build.SIGNATURES:
        assert f'extern "C" int {name}(' in text or f'extern "C" const char* {name}(' in text
    # every pointer and the stream as c_void_p: a c_int would cut them
    for name, n_ptr in (("ell_propagate_step", 8), ("argkmin", 11), ("bsr_spmv", 4),
                        ("cc_hook_step", 3)):
        argtypes, restype = _build.SIGNATURES[name]
        assert argtypes[:n_ptr] == [ctypes.c_void_p] * n_ptr
        assert argtypes[-1] is ctypes.c_void_p and restype is ctypes.c_int
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert len(_build.source_hash()) == 64
