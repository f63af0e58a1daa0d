"""Port vs reference, the frontier-sweep kernel module.

On the CPU the port's wrapper runs its plain version, which is held against
the JAX Pallas kernel (interpret mode) and the JAX oracle within 1e-6: the
two packages sum the K lanes in different orders (XLA's reduction vs column
order), so F′ may differ by a few float32 ULPs of values in [0, 1]; the
``changed`` flags must be equal.  The CUDA kernel itself only runs on the
card: ``tests/test_torch_cuda.py`` holds it to the plain version's bits.
"""

import ctypes
import re

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


def test_ptxas_report_reads_registers_stack_and_spills():
    log = """ptxas info    : Compiling entry function '_Z6kernelILi16ELi16EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi16ELi16EEvv
    64 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 122 registers, used 1 barriers, 20736 bytes smem
ptxas info    : Function properties for _Z6helperv
    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z5emptyv' for 'sm_90a'
ptxas info    : Used 4 registers, used 0 barriers
"""
    rep = _build.ptxas_report(log)
    assert set(rep) == {"_Z6kernelILi16ELi16EEvv", "_Z5emptyv"}  # no register line: no kernel
    k = rep["_Z6kernelILi16ELi16EEvv"]
    assert (k.registers, k.stack_bytes, k.spill_stores, k.spill_loads) == (122, 64, 8, 4)
    e = rep["_Z5emptyv"]
    assert (e.registers, e.stack_bytes, e.spill_stores, e.spill_loads) == (4, 0, 0, 0)


def test_build_inputs_are_declared():
    assert [p.name for p in _build.sources()] == [
        "argkmin.cu", "argkmin_tkb16.cu", "argkmin_tkb32.cu", "argkmin_tkb8.cu", "bsr_spmv.cu",
        "cc_hook.cu", "ell_propagate.cu", "knn_rerank.cu"]
    assert [p.name for p in _build.headers()] == ["argkmin.cuh"]
    text = "".join(p.read_text() for p in _build.sources())
    for name in _build.SIGNATURES:
        assert f'extern "C" int {name}(' in text or f'extern "C" const char* {name}(' in text
    # every pointer and the stream as c_void_p: a c_int would cut them
    for name, n_ptr in (("ell_propagate_step", 8), ("argkmin", 11), ("bsr_spmv", 4),
                        ("cc_hook_step", 3), ("cc_fixpoint", 4), ("knn_rerank", 4)):
        argtypes, restype = _build.SIGNATURES[name]
        assert argtypes[:n_ptr] == [ctypes.c_void_p] * n_ptr
        assert argtypes[-1] is ctypes.c_void_p and restype is ctypes.c_int
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert len(_build.source_hash()) == 64


def _sweep_constant(name):
    """An ``int`` constant of the sweep's CUDA source (its launch shape)."""
    text = (_build.CSRC / "ell_propagate.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("k", [0, 1, 7, 24, 31, 32, 33, 64])
def test_sweep_tile_stride_and_shared_memory(k):
    """The launcher's tile: an odd row stride above the chunk's width, so
    lane r's reads of its row (column j at r * stride + j) hit distinct
    banks, and the tile of p and w plus F_u for every warp of a block
    within the 48 KB a launch gets without asking."""
    chunk, warps = _sweep_constant("kChunk"), _sweep_constant("kWarps")
    assert chunk == 32
    src = (_build.CSRC / "ell_propagate.cu").read_text()
    assert "const int stride = ((k < kChunk ? k : kChunk) + 1) | 1;" in src
    stride = (min(k, chunk) + 1) | 1
    assert stride % 2 == 1 and stride > min(k, chunk)
    for j in range(min(k, chunk)):
        assert len({(r * stride + j) % 32 for r in range(32)}) == 32
    assert warps * (2 * 32 * stride + 32) * 4 <= 48 * 1024


@pytest.mark.parametrize("k", [1, 2, 3, 7, 24, 31, 32, 33, 64, 65])
@pytest.mark.parametrize("bits", [0xFFFFFFFF, 0x80000001, 0x00000080, 0x5A5A5A5A,
                                  0x00000001, 0x0000FFFF, 0x007FFFFF, 0x00FFFFFF])
def test_sweep_walk_covers_every_frontier_lane_once(k, bits):
    """The kernel's walk of a warp's 32 rows, per column chunk c0 of width
    kc: with fewer frontier rows than kc, item i is the i-th frontier row
    (lane = column); else item t is a flat step, lane l taking e = 32 t + l,
    row e * ceil(2^32 / kc) >> 32 and column e - row * kc.  Every frontier
    (row, column) comes exactly once, no other, and a row's columns come
    chunk by chunk in column order (23 and 24 frontier rows sit on either
    side of the switch at K = 24)."""
    chunk = _sweep_constant("kChunk")
    rows = [r for r in range(32) if bits >> r & 1]
    seen = []
    for c0 in range(0, k, chunk):
        kc = min(chunk, k - c0)
        magic = ((1 << 32) + kc - 1) // kc
        if len(rows) < kc:
            seen += [(r, c0 + lane) for r in rows for lane in range(32) if lane < kc]
            continue
        for t in range(kc):
            for lane in range(32):
                e = t * 32 + lane
                r = (e * magic) >> 32
                assert r == e // kc < 32
                if bits >> r & 1:
                    seen.append((r, c0 + e - r * kc))
    assert sorted(seen) == [(r, c) for r in rows for c in range(k)]


def _kernel_rows(nbr, wgt, wl0, wl1, frontier, f, delta, cols=32):
    """The kernel's arithmetic in numpy float32 (each op rounded on its
    own): p = w * d and w of a row's columns, ``cols`` at a time (the
    kernel's chunk), folded into the running sums in column order."""
    n, k = nbr.shape
    f32 = np.float32
    fu = f[:n]
    nbr_term = np.zeros(n, f32)
    wsum = np.zeros(n, f32)
    for c0 in range(0, k, cols):
        for u in range(cols):
            if c0 + u >= k:
                continue
            v, w = nbr[:, c0 + u], wgt[:, c0 + u]
            d = np.where(v >= 0, f[np.maximum(v, 0)] - fu, f32(0))
            nbr_term = (nbr_term + w * d).astype(f32)
            wsum = (wsum + w).astype(f32)
    wall = ((wsum + wl0).astype(f32) + wl1).astype(f32)
    df = (((f32(0) - fu) * wl0).astype(f32) + ((f32(1) - fu) * wl1).astype(f32)
          + nbr_term).astype(f32)
    with np.errstate(divide="ignore", invalid="ignore"):
        upd = np.where(wall > 0, df / np.maximum(wall, f32(1e-30)), f32(0)).astype(f32)
    fnew = np.where(frontier, (fu + upd).astype(f32), fu)
    return fnew, np.abs((fnew - fu).astype(f32)) > f32(delta)


@pytest.mark.parametrize("k", [1, 3, 4, 15, 16, 17, 24, 32, 33, 64])
@pytest.mark.parametrize("frontier", ["all", "random"])
@pytest.mark.parametrize("pad_rows", [0.0, 0.3])
def test_kernel_order_gives_the_plain_versions_bits(k, frontier, pad_rows):
    """The kernel's per-row order (column chunks folded in column order,
    PAD lanes giving 0) is the plain version's op for op: the same bits, on
    rows that are all PAD too, and the same ``changed`` flags."""
    rng = np.random.default_rng(100 + k)
    n = 257
    nbr, wgt, wl0, wl1, fr, f = _inputs(rng, n, k)
    pad = rng.random(n) < pad_rows
    nbr[pad] = -1
    wgt[pad] = 0.0
    dead = pad & (np.arange(n) % 2 == 0)  # all-PAD rows with Wall == 0
    wl0[dead] = 0.0
    wl1[dead] = 0.0
    if frontier == "all":
        fr[:] = True
    want_f, want_ch = ell_propagate_ref(*_torch((nbr, wgt, wl0, wl1, fr, f)), delta=1e-4)
    got_f, got_ch = _kernel_rows(nbr, wgt, wl0, wl1, fr, f, 1e-4)
    np.testing.assert_array_equal(got_f.view(np.int32), want_f.numpy().view(np.int32))
    np.testing.assert_array_equal(got_ch, want_ch.numpy())
