"""The port's Shiloach–Vishkin hook step against the JAX package's, on the CPU.

Mirrors the ``cc_hook`` cases of ``tests/test_kernels.py``.  The JAX side
runs its Pallas kernel in interpret mode.  Labels are exact integers, so
the step, the fixpoint labels and the iteration counts must be equal.  The
CUDA kernels' warp walk and their fixpoint's stopping rule are emulated
here in numpy, cell for cell, against the same references.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.structures import coo_to_csr, csr_to_ell_fast
from repro.kernels import cc_hook as jcc
from repro.kernels import ref as jref
from repro_torch.core.components import connected_components, host_components
from repro_torch.kernels._build import CSRC
from repro_torch.kernels.cc_hook import (cc_fixpoint, cc_hook_ref, cc_hook_step,
                                         connected_components_cuda, connected_components_ref)

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


def _directed_ell(n, k, pad, pad_rows, seed):
    """Random directed lanes, a share ``pad`` of them -1, and a share
    ``pad_rows`` of the rows all -1."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, max(n, 1), size=(n, k)).astype(np.int32)
    nbr[rng.random((n, k)) < pad] = -1
    nbr[rng.random(n) < pad_rows] = -1
    return nbr


# K on both sides of 4 and of the 32-column chunk, N below and off 32,
# rows with every lane PAD
EDGE_CASES = [(100, 3, 0.2, 0.0), (100, 4, 0.0, 0.0), (70, 33, 0.3, 0.1), (20, 24, 0.2, 0.0),
              (97, 4, 0.3, 0.4), (45, 1, 0.5, 0.0)]


@pytest.mark.parametrize("n,k,pad,pad_rows", EDGE_CASES)
def test_hook_step_edge_cases_match_reference(n, k, pad, pad_rows):
    nbr = _directed_ell(n, k, pad, pad_rows, seed=n * 7 + k)
    par = np.random.default_rng(k).permutation(n).astype(np.int32)
    want = np.asarray(jcc.cc_hook_step(jnp.asarray(nbr), jnp.asarray(par), block_rows=n))
    got = cc_hook_step(torch.from_numpy(nbr), torch.from_numpy(par))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("max_iters", [None, 1, 2])
@pytest.mark.parametrize("n,k,pad,pad_rows", EDGE_CASES)
def test_fixpoint_edge_cases_match_reference(n, k, pad, pad_rows, max_iters):
    """``connected_components_cuda`` and ``cc_fixpoint`` against
    ``connected_components_pallas`` with the same cap: labels and
    iteration counts exactly equal."""
    nbr = _directed_ell(n, k, pad, pad_rows, seed=n * 7 + k)
    kw = {} if max_iters is None else dict(max_iters=max_iters)
    jpar, jiters = jcc.connected_components_pallas(jnp.asarray(nbr), block_rows=n, **kw)
    par, iters = connected_components_cuda(torch.from_numpy(nbr), **kw)
    np.testing.assert_array_equal(par.numpy(), np.asarray(jpar))
    assert iters == int(jiters)
    fpar, fiters = cc_fixpoint(torch.from_numpy(nbr), **kw)
    assert fpar.dtype == torch.int32 and fiters.dtype == torch.int32
    np.testing.assert_array_equal(fpar.numpy(), np.asarray(jpar))
    assert int(fiters) == int(jiters)
    if max_iters is not None:
        assert iters <= max_iters


def _cu_constants():
    """The CUDA source's launch constants, for the emulation below."""
    text = (CSRC / "cc_hook.cu").read_text()
    consts = {}
    for name in ("kWarps", "kCells"):
        consts[name] = int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
    assert "constexpr int kStride = kCells + 1;" in text
    consts["kStride"] = consts["kCells"] + 1
    return consts


def _warp_walk(nbr, par, vec, group, out, src=None, keep=None):
    """``hook_rows`` of ``csrc/cc_hook.cu`` for one row group, cell for
    cell: each lane's cells lane, lane + 32, ... of a pass (stepped as
    ``Cells`` steps them), gathered, folded into the tile at (row, cell)
    with the tile's stride, then each row's lane folds its row and jumps.
    ``src`` = (array, offset) is where the group's lanes are read (default:
    ``nbr`` itself) and ``keep`` = (array, offset) where each cell read is
    also stored, as the fixpoint keeps them in shared memory.  Returns the
    rows that moved."""
    c = _cu_constants()
    per_pass, stride = c["kCells"], c["kStride"]
    n, k = nbr.shape
    row0 = group * 32
    src_arr, src_at = src if src is not None else (nbr.reshape(-1), row0 * k)
    rows = min(32, n - row0)
    low = np.full(32, np.iinfo(np.int32).max, np.int64)
    each = 4 if vec else 1
    for c0 in range(0, k, per_pass * each):
        width = min(per_pass, (k - c0) // each)
        assert width * each == min(per_pass * each, k - c0)
        tile = np.full(32 * stride, -7, np.int64)  # stale values must never be read
        written = set()
        cells = rows * width
        for lane in range(32):
            r, j = divmod(lane, width)
            dr, dj = divmod(32, width)
            for i in range(per_pass):
                if 32 * i >= cells:
                    break
                if r < rows:
                    off = c0 + r * k + j * each
                    at = src_at + off
                    if vec:
                        assert at % 4 == 0  # a 16-byte load off a 16-byte base
                    vs = src_arr[at:at + each]
                    assert len(vs) == each
                    if keep is not None:
                        keep[0][keep[1] + off:keep[1] + off + each] = vs
                    g = [par[v] if v >= 0 else np.iinfo(np.int32).max for v in vs]
                    assert (r, j) not in written
                    written.add((r, j))
                    tile[r * stride + j] = min(g)
                r, j = r + dr, j + dj
                if j >= width:
                    j, r = j - width, r + 1
        assert written == {(r, j) for r in range(rows) for j in range(width)}
        for lane in range(rows):
            low[lane] = min(low[lane], tile[lane * stride:lane * stride + width].min())
    moved = []
    for lane in range(rows):
        u = row0 + lane
        out[u] = par[min(par[u], low[lane])]
        if out[u] != par[u]:
            moved.append(u)
    return moved


def _fixpoint_walk(nbr, max_iters, blocks, keep_groups=0):
    """``cc_fixpoint_kernel`` with ``blocks`` blocks: every warp strides
    over the row groups, keeps the lanes of its first ``keep_groups`` in
    its block's shared memory at step 0 and reads them there after, two
    buffers swap each step, and a block that moved a row raises the word
    to the step's number; every block stops once the word is below it.
    Returns (labels in the first buffer, steps)."""
    warps = _cu_constants()["kWarps"]
    n, k = nbr.shape
    vec = k > 0 and k % 4 == 0
    groups = -(-n // 32)
    # stale values a kept copy must overwrite before they are read
    shared = [np.full(warps * keep_groups * 32 * k, -5, np.int64) for _ in range(blocks)]
    bufs = [np.arange(n, dtype=np.int64), np.empty(n, np.int64)]
    word, it = 0, 0
    while it < max_iters:
        par, out = bufs[it & 1], bufs[(it + 1) & 1]
        moved_blocks = set()
        for block in range(blocks):
            for w in range(warps):
                for j, g in enumerate(range(block * warps + w, groups, blocks * warps)):
                    mine = (shared[block], (w * keep_groups + j) * 32 * k)
                    if j >= keep_groups:
                        moved = _warp_walk(nbr, par, vec, g, out)
                    elif it > 0:
                        moved = _warp_walk(nbr, par, vec, g, out, src=mine)
                    else:
                        moved = _warp_walk(nbr, par, vec, g, out, keep=mine)
                    if moved:
                        moved_blocks.add(block)
        it += 1
        if moved_blocks:
            word = max(word, it)
        if word < it:
            break
    if it & 1:
        bufs[0][:] = bufs[1]
    return bufs[0], it


@pytest.mark.parametrize("n,k,pad,pad_rows", EDGE_CASES + [(300, 40, 0.2, 0.1),
                                                           (66, 36, 0.1, 0.0)])
def test_kernel_walk_matches_reference(n, k, pad, pad_rows):
    """The kernels' warp walk (16-byte cells where K % 4 == 0, 4-byte cells
    always) gives the plain step, and their fixpoint, whatever the number
    of blocks and of row groups kept in shared memory, gives the JAX
    loop's labels and step count."""
    nbr = _directed_ell(n, k, pad, pad_rows, seed=n + 3 * k)
    par = np.random.default_rng(n).permutation(n).astype(np.int64)
    want = cc_hook_ref(torch.from_numpy(nbr), torch.from_numpy(par.astype(np.int32))).numpy()
    for vec in ({False, k > 0 and k % 4 == 0}):
        out = np.full(n, -1, np.int64)
        for g in range(-(-n // 32)):
            _warp_walk(nbr, par, vec, g, out)
        np.testing.assert_array_equal(out, want)
    jpar, jiters = jcc.connected_components_pallas(jnp.asarray(nbr), block_rows=n)
    warps = _cu_constants()["kWarps"]
    for blocks in (1, 3):
        every = -(-(-(-n // 32)) // (blocks * warps))  # row groups a warp
        for keep_groups in {0, 1, every}:
            labels, iters = _fixpoint_walk(nbr, 10_000, blocks, keep_groups)
            np.testing.assert_array_equal(labels, np.asarray(jpar))
            assert iters == int(jiters)
    labels, iters = _fixpoint_walk(nbr, 1, 1)
    jpar1, jiters1 = jcc.connected_components_pallas(jnp.asarray(nbr), block_rows=n, max_iters=1)
    np.testing.assert_array_equal(labels, np.asarray(jpar1))
    assert iters == int(jiters1) == 1


def test_tile_stride_and_shared_memory():
    """Row r's lane reads its row's cell j at r * stride + j: distinct banks
    for every j; the tiles of a block's warps fit the 48 KB a launch gets
    without asking, four blocks an SM within Hopper's 227 KB."""
    c = _cu_constants()
    stride, warps = c["kStride"], c["kWarps"]
    assert stride % 2 == 1 and stride > c["kCells"]
    for j in range(c["kCells"]):
        assert len({(r * stride + j) % 32 for r in range(32)}) == 32
    tile_bytes = warps * 32 * stride * 4
    assert tile_bytes <= 48 * 1024 and 4 * tile_bytes <= 227 * 1024
