"""The stream cell on the CPU: its seeded batches, the plain replay of the
dynamic graph against brute force from the guarantees' own words, and
tiny runs with the timed path broken underneath, which the check fails."""

import dataclasses
import time

import numpy as np
import pytest

from portbench import harness
from portbench.generator import UNLABELED, make_stream
from portbench.reference import knn as rk
from portbench.reference.stream import replay

CELL = "imdb-50k.stream"
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
TINY = 3000  # three batches of 1,000


def _cfg_mix(vertices=TINY):
    _, cfg, mix, _, _ = harness.cell_spec(BENCH, CELL)
    return dict(cfg, vertices=vertices), mix


# ---------------------------------------------------------------------- #
# the batches
# ---------------------------------------------------------------------- #
def test_same_seed_same_stream():
    cfg, mix = _cfg_mix()
    a, b = make_stream(cfg, mix, 2**31 + 17), make_stream(cfg, mix, 2**31 + 17)
    assert a.x.tobytes() == b.x.tobytes() and a.bounds == b.bounds
    assert all(np.array_equal(p, q) for p, q in zip(a.labels + a.dels, b.labels + b.dels))


@pytest.mark.parametrize("seed", [5, 2**40 + 3, -7])
def test_every_seed_the_same_sizes(seed):
    cfg, mix = _cfg_mix()
    s = make_stream(cfg, mix, seed)
    size = mix["batch_size"]
    assert s.x.shape == (TINY, cfg["emb_dim"]) and s.x.dtype == np.float32
    assert (s.cls == 1).sum() == TINY // 2
    assert s.bounds == [(lo, lo + size) for lo in range(0, TINY, size)]
    for (lo, hi), y, d in zip(s.bounds, s.labels, s.dels):
        seeds = np.flatnonzero(y != UNLABELED)
        assert len(seeds) == round(mix["labeled_share"] * size)
        assert (y[seeds] == s.cls[lo + seeds]).all()  # seeds carry their true class
        assert len(d) == (round(mix["deleted_share"] * size) if lo else 0)
        assert ((d >= 0) & (d < lo)).all()  # only ids already handed out


# ---------------------------------------------------------------------- #
# the replay against brute force
# ---------------------------------------------------------------------- #
def _brute(x, bounds, labels, dels, k):
    """The guarantees step by step, every weight from one full matrix."""
    xh = rk.normalize_rows(x)
    w = rk.canonical_weights(xh[:, None, :], xh[None, :, :])
    order = lambda r, ids: sorted(ids, key=lambda j: (-w[r, j], j))[:k]  # noqa: E731
    lists, alive, out = {}, set(), []
    for (lo, hi), y, d in zip(bounds, labels, dels):
        for v in {int(v) for v in d if v < lo} & alive:
            alive.discard(v)
            del lists[v]
            for r in lists:
                lists[r] = [j for j in lists[r] if j != v]
        old = sorted(alive)
        new = list(range(lo, hi))
        alive |= set(new)
        for i in new:
            lists[i] = order(i, alive - {i})
        for r in old:
            lists[r] = order(r, lists[r] + new)
        idx = np.full((hi, k), -1, np.int64)
        wgt = np.full((hi, k), -np.inf, np.float32)
        for r, ids in lists.items():
            idx[r, :len(ids)] = ids
            wgt[r, :len(ids)] = w[r, ids]
        out.append((idx, wgt, np.isin(np.arange(hi), sorted(alive))))
    return out


def _stream(n, batch, d, k, seed, dup):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if dup:  # exact duplicates, within a batch and across batches: ties by id
        x[1:dup + 1] = x[0]
        x[batch + 3:batch + 3 + dup] = x[0]
        x[2 * batch + 1] = x[batch + 7]
    bounds = [(lo, min(lo + batch, n)) for lo in range(0, n, batch)]
    labels = [np.where(rng.random(hi - lo) < 0.1, rng.integers(0, 2, hi - lo), -1)
              .astype(np.int8) for lo, hi in bounds]
    # deletions: repeats, ids already dead, and ids not handed out yet
    dels = [rng.integers(0, lo + batch // 2, size=batch // 3) if lo else np.zeros(0, np.int64)
            for lo, hi in bounds]
    return x, bounds, labels, dels


@pytest.mark.parametrize("n,batch,d,k,dup", [(240, 40, 16, 5, 0), (210, 35, 16, 3, 6),
                                             (240, 60, 128, 5, 4), (90, 7, 8, 5, 0)])
def test_replay_is_the_guarantees_by_brute_force(n, batch, d, k, dup):
    x, bounds, labels, dels = _stream(n, batch, d, k, seed=n + d, dup=dup)
    got = list(replay(x, bounds, labels, dels, k))
    want = _brute(x, bounds, labels, dels, k)
    assert len(got) == len(want)
    for st, (idx, wgt, alive) in zip(got, want):
        assert np.array_equal(st.alive, alive)
        live = np.flatnonzero(alive)
        assert np.array_equal(st.idx[live], idx[live])
        assert np.array_equal(st.wgt[live], wgt[live])
    assert not got[-1].alive.all()  # the deletions ran
    assert np.array_equal(got[-1].labels, np.concatenate(labels))


def test_residual_reads_how_far_scores_are_from_solving_the_problem():
    """0 at the linear solve's scores, and a moved score's own move on its
    row, by the row's own weights on its neighbours' rows."""
    from portbench.reference import propagation as rp

    x, bounds, labels, dels = _stream(240, 60, 16, 5, seed=3, dup=0)
    st = list(replay(x, bounds, labels, dels, 5))[-1]
    live = np.flatnonzero(st.alive)
    remap = np.full(len(st.alive), -1, np.int64)
    remap[live] = np.arange(len(live))
    i = st.idx[live]
    p = rp.build_problem(np.where(i >= 0, remap[np.maximum(i, 0)], -1), st.wgt[live],
                         st.labels[live], 20)
    det = rp.determined(p)
    assert det.any() and np.array_equal(det, rp.fixed_point(p).determined)
    f = rp.fixed_point(p).f
    assert rp.residual(p, f)[det].max() < 1e-9
    u = int(np.flatnonzero(det & (p.nbr[:, 0] >= 0))[0])
    g = f.copy()
    g[u] += 0.25
    r = rp.residual(p, g)
    assert r[u] == pytest.approx(0.25, abs=1e-9)
    for v in np.flatnonzero(r > 1e-6):  # u's move reaches the rows that list u
        if v != u:
            wall = p.wgt[v].sum() + p.wl0[v] + p.wl1[v]
            assert r[v] == pytest.approx(0.25 * p.wgt[v][p.nbr[v] == u].sum() / wall)


# ---------------------------------------------------------------------- #
# faults planted under a tiny run
# ---------------------------------------------------------------------- #
def _run():
    """A tiny run: its window is one whole pass of three Δ_t, so the faults
    reach past Δ_0, the one batch without old rows and deletions."""
    out = harness.run(CELL, 2**31 + 29, 0.01, False, t_start=time.perf_counter(), device="cpu",
                      overrides={"vertices": TINY})
    assert out["attempted"] == 3
    return out


def test_sound_stream_run_is_correct():
    assert _run()["correct"] is True


def test_a_deletion_left_unapplied(monkeypatch):
    from repro_torch.graph.dynamic import DynamicGraph

    orig = DynamicGraph.apply_batch

    def spare_one(self, batch, *args, **kwargs):
        d = np.asarray(batch.del_ids, np.int64)
        live = d[(d < self.num_nodes)]
        live = live[self.alive[live]]
        if len(live):
            batch = dataclasses.replace(batch, del_ids=d[d != live[0]])
        return orig(self, batch, *args, **kwargs)

    monkeypatch.setattr(DynamicGraph, "apply_batch", spare_one)
    out = _run()
    assert out["correct"] is False
    assert out["check"]["knn_gap"]["value"] == 1.0


def test_one_batchs_merges_skipped(monkeypatch):
    from repro_torch.ingest.incremental_knn import DeviceIngestor

    orig = DeviceIngestor.select

    def no_merges(self, g, new_ids, embn_new):
        sel = orig(self, g, new_ids, embn_new)
        if new_ids[0] == len(new_ids):  # Δ_1: old rows keep lists a new row beats
            sel.flagged = sel.flagged[:0]
        return sel

    monkeypatch.setattr(DeviceIngestor, "select", no_merges)
    out = _run()
    assert out["correct"] is False
    assert out["check"]["knn_gap"]["value"] > out["check"]["knn_gap"]["limit"]


def test_a_committed_label_altered(monkeypatch):
    from repro_torch.core.snapshot import LabelView
    from repro_torch.core.stream import StreamEngine

    orig = StreamEngine.drain

    def flip(self):
        st = orig(self)
        v = self._view
        unl = np.flatnonzero(v.alive & (v.labels == UNLABELED))
        if st is not None and len(unl):
            f = v.f.copy()
            u = unl[np.argmax(np.abs(f[unl] - 0.5))]
            f[u] = 1.0 - f[u]
            self._view = LabelView(f=f, labels=v.labels, alive=v.alive,
                                   commit_id=v.commit_id)
        return st

    monkeypatch.setattr(StreamEngine, "drain", flip)
    out = _run()
    assert out["correct"] is False
    assert out["check"]["label_residual"]["value"] > out["check"]["label_residual"]["limit"]


def test_a_list_entry_altered(monkeypatch):
    from repro_torch.ingest.incremental_knn import DeviceIngestor

    orig = DeviceIngestor.select

    def worse(self, g, new_ids, embn_new):
        sel = orig(self, g, new_ids, embn_new)
        sel.cand_idx[:, 0] = -1  # every new row loses its best candidate
        return sel

    monkeypatch.setattr(DeviceIngestor, "select", worse)
    out = _run()
    assert out["correct"] is False
    assert out["check"]["knn_gap"]["value"] > out["check"]["knn_gap"]["limit"]
