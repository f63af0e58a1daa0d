"""Port vs reference, argkmin: the plain torch version of the device kNN
kernel against the JAX package's XLA twin and its Pallas kernel (interpret
mode), and the properties the ingest contract needs from it.

The contract (``graph.knn`` docstring) only needs candidate *supersets*
that cover the canonical top-k and an exact displacement mask, so candidate
sets and masks must be equal exactly.  Values may differ by an ULP or two:
XLA sums each dot product in its own order, the port in D order (the order
of its CUDA kernel).  The CUDA kernel itself is held to this plain version
bit for bit in ``tests/test_torch_cuda.py`` (card only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.argkmin import argkmin_candidates as jax_argkmin
from repro_torch.graph.knn import (
    SELECT_MARGIN,
    normalize_rows,
    pair_weights,
    selection_slack,
    topk_pairs,
)
from repro_torch.kernels.argkmin import (
    LIST_BOUNDS,
    ROWS_PER_BLOCK,
    _weights,
    argkmin_candidates,
    argkmin_geometry,
    argkmin_ref,
    merge_topk,
)

torch.set_num_threads(1)


def _make(rng, c, d, m, dead_frac=0.1, dup=False):
    """Store of ``c`` rows whose last ``m`` are the arriving batch (the
    reference test's inputs)."""
    emb = rng.normal(size=(c, d)).astype(np.float32)
    if dup:  # mass duplicates force deep ties
        emb[: c // 2] = emb[0]
    embn = normalize_rows(emb)
    base_id = c - m
    valid = np.ones(c, bool)
    n_dead = int(dead_frac * base_id)
    if n_dead:
        valid[rng.choice(base_id, n_dead, replace=False)] = False
    kth = np.full(c, -np.inf, np.float32)
    kth[:base_id] = rng.uniform(0.4, 0.9, base_id).astype(np.float32)
    kth[rng.choice(c, max(1, c // 8), replace=False)] = -np.inf
    return embn, valid, kth, embn[base_id:].copy(), np.ones(m, bool), base_id


def _port(embn, valid, kth, batch, bvalid, base_id, d, k):
    val, idx, disp = argkmin_candidates(
        *(torch.from_numpy(a) for a in (embn, valid, kth, batch, bvalid)),
        base_id, selection_slack(d), k=k)
    return val.numpy(), idx.numpy(), disp.numpy()


def _seq_weights(batch, store):
    """numpy ``(batch·storeᵀ + 1) * 0.5`` summed in D order, each op rounded
    in float32: the port's arithmetic, written out independently."""
    acc = np.zeros((len(batch), len(store)), np.float32)
    for d in range(batch.shape[1]):
        acc = acc + np.multiply(batch[:, d, None], store[None, :, d], dtype=np.float32)
    return (acc + np.float32(1.0)) * np.float32(0.5)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("c,d,m,k", [(256, 16, 8, 5), (512, 33, 16, 3)])
def test_plain_version_matches_reference(c, d, m, k, dup, backend):
    rng = np.random.default_rng(c + d + dup)
    args = _make(rng, c, d, m, dup=dup)
    embn, valid, kth, batch, bvalid, base_id = args
    jv, ji, jd = (np.asarray(a) for a in jax_argkmin(
        jnp.asarray(embn), jnp.asarray(valid), jnp.asarray(kth), jnp.asarray(batch),
        jnp.asarray(bvalid), base_id, selection_slack(d), k=k, backend=backend,
        block_rows=128, interpret=True))
    tv, ti, td = _port(*args, d, k)
    assert tv.shape == jv.shape == (m, min(k + SELECT_MARGIN, c))
    np.testing.assert_array_equal(td, jd)
    for q in range(m):
        jmap = dict(zip(ji[q][np.isfinite(jv[q])], jv[q][np.isfinite(jv[q])]))
        tmap = dict(zip(ti[q][np.isfinite(tv[q])], tv[q][np.isfinite(tv[q])]))
        assert set(tmap) == set(jmap), q
        ids = sorted(tmap)
        np.testing.assert_array_max_ulp(np.array([tmap[i] for i in ids]),
                                        np.array([jmap[i] for i in ids]), maxulp=2)
    # the port's own order: value desc, then id asc
    for q in range(m):
        order = np.lexsort((ti[q], -tv[q]))
        np.testing.assert_array_equal(order, np.arange(tv.shape[1]))


def test_no_self_no_dead_candidates():
    rng = np.random.default_rng(3)
    c, d, m, k = 256, 12, 16, 4
    embn, valid, kth, batch, bvalid, base_id = _make(rng, c, d, m, dead_frac=0.3)
    val, idx, disp = _port(embn, valid, kth, batch, bvalid, base_id, d, k)
    rows, cols = np.nonzero(np.isfinite(val))
    cand = idx[rows, cols]
    assert not (cand == base_id + rows).any()  # no self
    assert valid[cand].all()  # no dead rows
    assert not disp[~valid].any() and not disp[base_id:].any()
    assert (idx[~np.isfinite(val)] == -1).all()


def test_candidates_cover_canonical_topk():
    """Every canonical top-k neighbor (``pair_weights`` total order) is in
    the candidate superset."""
    rng = np.random.default_rng(11)
    c, d, m, k = 384, 24, 24, 5
    embn, valid, kth, batch, bvalid, base_id = _make(rng, c, d, m)
    w = pair_weights(batch[:, None, :], embn[None, :, :]).copy()
    ids = np.broadcast_to(np.arange(c, dtype=np.int64), w.shape).copy()
    w[:, ~valid] = -np.inf
    w[np.arange(m), base_id + np.arange(m)] = -np.inf
    want_i, _ = topk_pairs(w, ids, k)
    val, idx, _ = _port(embn, valid, kth, batch, bvalid, base_id, d, k)
    for q in range(m):
        need = set(want_i[q][want_i[q] >= 0])
        assert need <= set(idx[q][np.isfinite(val[q])]), q


def test_displacement_mask_matches_slack_rule():
    """disp == old valid rows whose kth some valid batch row beats within
    slack, from the definition (padding batch rows never count)."""
    rng = np.random.default_rng(5)
    c, d, m, k = 256, 10, 8, 4
    embn, valid, kth, batch, bvalid, base_id = _make(rng, c, d, m)
    bvalid[5:] = False
    w = _seq_weights(batch, embn)
    colmax = np.where(bvalid[:, None], w, -np.inf).max(axis=0)
    slack = np.float32(selection_slack(d))
    want = valid & (np.arange(c) < base_id) & (colmax > kth - slack)
    _, _, disp = _port(embn, valid, kth, batch, bvalid, base_id, d, k)
    np.testing.assert_array_equal(disp, want)
    # -inf kth: any valid batch row displaces; no valid batch row: nothing
    assert disp[(kth == -np.inf) & valid & (np.arange(c) < base_id)].all()
    _, _, none = _port(embn, valid, kth, batch, np.zeros(m, bool), base_id, d, k)
    assert not none.any()


def test_values_are_the_sequential_dot():
    """The plain version's values are the D-order float32 dot, bit for bit
    (what the CUDA kernel computes)."""
    rng = np.random.default_rng(6)
    c, d, m, k = 128, 16, 8, 5
    embn, valid, kth, batch, bvalid, base_id = _make(rng, c, d, m, dead_frac=0.0)
    val, idx, _ = _port(embn, valid, kth, batch, bvalid, base_id, d, k)
    w = _seq_weights(batch, embn)
    rows, cols = np.nonzero(np.isfinite(val))
    assert val[rows, cols].tobytes() == w[rows, idx[rows, cols]].tobytes()


def test_underfull_store_pads_with_minus_inf():
    """Fewer valid rows than TK: what exists comes back, the rest is
    (-inf, -1)."""
    rng = np.random.default_rng(9)
    d, k = 8, 5
    embn = normalize_rows(rng.normal(size=(16, d)).astype(np.float32))
    valid = np.zeros(16, bool)
    valid[:6] = True
    kth = np.full(16, -np.inf, np.float32)
    val, idx, disp = _port(embn, valid, kth, embn[3:6].copy(), np.ones(3, bool), 3, d, k)
    assert val.shape == (3, min(k + SELECT_MARGIN, 16))
    assert (np.isfinite(val).sum(axis=1) == 5).all()  # 6 valid rows minus self
    assert (idx[~np.isfinite(val)] == -1).all()
    np.testing.assert_array_equal(disp, np.arange(16) < 3)  # -inf kth: all old rows


@pytest.mark.parametrize("tile_rows", [1, 7, 100, 512])
def test_tile_walk_does_not_change_the_result(tile_rows):
    """The plain version's result does not depend on its store tile (the
    kernel's split-then-merge relies on the same property)."""
    rng = np.random.default_rng(12)
    c, d, m, k = 512, 16, 12, 5
    embn, valid, kth, batch, bvalid, base_id = _make(rng, c, d, m, dup=True)
    t = [torch.from_numpy(a) for a in (embn, valid, kth, batch, bvalid)]
    want = argkmin_ref(*t, base_id, 1e-5, topk=k + SELECT_MARGIN, tile_rows=c)
    got = argkmin_ref(*t, base_id, 1e-5, topk=k + SELECT_MARGIN, tile_rows=tile_rows)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_merge_topk_ties_go_to_the_lower_position():
    val = torch.tensor([[0.5, 0.75, 0.5, -np.inf, 0.75, 0.25]])
    idx = torch.tensor([[3, 4, 5, 7, 8, 9]], dtype=torch.int32)
    mval, midx = merge_topk(val, idx, 5)
    assert mval.tolist() == [[0.75, 0.75, 0.5, 0.5, 0.25]]
    assert midx.tolist() == [[4, 8, 3, 5, 9]]
    _, midx = merge_topk(val, idx, 6)
    assert midx[0, -1] == -1  # a -inf slot carries id -1


def test_wrapper_checks_its_inputs():
    rng = np.random.default_rng(1)
    embn, valid, kth, batch, bvalid, base_id = _make(rng, 64, 8, 4)
    t = [torch.from_numpy(a) for a in (embn, valid, kth, batch, bvalid)]
    before = argkmin_candidates.launches
    val, _, _ = argkmin_candidates(*t, base_id, 1e-5, k=60)
    assert val.shape == (4, 64)  # TK = min(k + margin, C)
    assert argkmin_candidates.launches == before  # CPU tensors launch nothing
    with pytest.raises(TypeError, match="kth"):
        argkmin_candidates(t[0], t[1], t[2].double(), t[3], t[4], base_id, 1e-5, k=5)
    with pytest.raises(ValueError, match="batch"):
        argkmin_candidates(t[0], t[1], t[2], t[3][:, :4].contiguous(), t[4], base_id,
                           1e-5, k=5)


@pytest.mark.parametrize("c,d,m,topk,resident", [
    (131072, 16, 8192, 13, 1056),  # the main path's last call
    (131072, 16, 8192, 13, 528),  # four blocks an SM
    (131072, 128, 8192, 13, 264),  # D = 128: fewer blocks fit
    (131072, 16, 8192, 32, 264),  # the widest list bound
    (100_000, 16, 5000, 13, 528),  # a batch off the block rows
    (1000, 16, 8, 13, 1056),  # C < one split of the main path
    (256, 16, 8, 13, 1056),  # C = one tile
    (8, 8, 3, 8, 1056),  # C = TK
    (3001, 40, 100, 9, 1056),
    (3001, 40, 100, 16, 1056),
    (3001, 40, 100, 17, 1056),
    (5000, 128, 300, 32, 264),
    (5000, 8, 300, 1, 264),
    (700, 8, 40_000, 1, 1056),  # more row blocks than resident blocks
    (10**6, 64, 128, 13, 1056),  # many tiles, one row block
    (10**6, 64, 128, 13, 1),  # one resident block
])
def test_argkmin_geometry(c, d, m, topk, resident):
    """The list bound is the smallest that holds TK; the interleaved splits
    cover the store once, every split with a tile; one wave of the pass
    fits in ``resident``; the tile fits the static shared memory."""
    geo = argkmin_geometry(c, d, m, topk, resident=resident)
    assert geo["tkb"] == min(b for b in LIST_BOUNDS if b >= topk)
    assert (geo["row_blocks"] - 1) * ROWS_PER_BLOCK < m <= geo["row_blocks"] * ROWS_PER_BLOCK
    assert geo["tile_rows"] % 8 == 0 and geo["tile_rows"] * d <= 4096
    assert 1 <= geo["splits"] <= -(-c // geo["tile_rows"])
    assert geo["blocks"] == geo["row_blocks"] * geo["splits"]
    assert geo["blocks"] <= max(resident, geo["row_blocks"])
    assert geo["smem_bytes"] <= 48 * 1024


def test_argkmin_geometry_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="candidates"):
        argkmin_geometry(100, 16, 8, 33)
    with pytest.raises(ValueError, match="D=12"):
        argkmin_geometry(100, 12, 8, 5)


def _lex_top(val, idx, topk):
    """Top-``topk`` of (M, W) candidates under (value desc, id asc); slots
    whose value is -inf come back as (-inf, -1)."""
    order = torch.argsort(idx.to(torch.int64), dim=1, stable=True)
    val, idx = val.gather(1, order), idx.gather(1, order)
    order = torch.argsort(val, dim=1, descending=True, stable=True)[:, :topk]
    val, idx = val.gather(1, order), idx.gather(1, order)
    return val, torch.where(val == -np.inf, torch.full_like(idx, -1), idx)


def _emulate(store, valid, batch, base_id, topk, geo):
    """The kernel's list scheme in torch: split s takes tiles s, s + S, ...
    of the store in ascending order, and a row enters its list only if it
    beats the list's TK-th value strictly (so a tie keeps the lower row);
    the split lists are merged under (value desc, row asc)."""
    m = batch.shape[0]
    neg = torch.tensor(-np.inf)
    self_row = base_id + torch.arange(m)
    vals, idxs = [], []
    tiles = torch.arange(store.shape[0]).split(geo["tile_rows"])
    for s in range(geo["splits"]):
        rows = torch.cat(tiles[s::geo["splits"]])
        w = _weights(batch, store[rows])
        ok = valid[rows][None, :] & (rows[None, :] != self_row[:, None])
        pad = torch.full((m, topk), -np.inf)  # a list always has TK slots
        v, i = _lex_top(torch.cat([torch.where(ok, w, neg), pad], 1),
                        torch.cat([rows.to(torch.int32).expand(m, -1),
                                   torch.full((m, topk), -1, dtype=torch.int32)], 1), topk)
        vals.append(v)
        idxs.append(i)
    return _lex_top(torch.cat(vals, 1), torch.cat(idxs, 1), topk)


@pytest.mark.parametrize("case", ["random", "ties", "top_in_first_split", "top_in_last_split",
                                  "under_full_split"])
@pytest.mark.parametrize("resident", [2, 3, 6])
def test_thresholded_splits_give_the_plain_versions_lists(case, resident):
    """The kernel's scheme (interleaved splits, each list thresholded by
    its own TK-th value, merge under (value desc, row asc)) gives
    ``argkmin_ref``'s values and ids bit for bit, wherever the top-TK lies
    and however many splits share the store."""
    rng = np.random.default_rng(5)
    c, d, m, k = 3000, 8, 20, 5
    embn, valid, kth, batch, bvalid, base_id = _make(rng, c, d, m, dup=case == "ties")
    if case == "ties":  # mass ties straddling every split boundary
        embn[::3] = embn[0]
        batch = embn[base_id:].copy()
    elif case == "top_in_first_split":
        embn[: 40] = batch[0]
    elif case == "top_in_last_split":
        embn[base_id - 40: base_id] = batch[0]
    elif case == "under_full_split":  # the first tile all dead
        valid[: 600] = False
    topk = min(k + SELECT_MARGIN, c)
    geo = argkmin_geometry(c, d, m, topk, resident=resident)
    t = [torch.from_numpy(a) for a in (embn, valid, kth, batch, bvalid)]
    want_val, want_idx, _ = argkmin_ref(*t, base_id, selection_slack(d), topk=topk)
    got_val, got_idx = _emulate(t[0], t[1], t[3], base_id, topk, geo)
    assert geo["splits"] == resident
    assert torch.equal(got_val.view(torch.int32), want_val.view(torch.int32))
    assert torch.equal(got_idx, want_idx)
