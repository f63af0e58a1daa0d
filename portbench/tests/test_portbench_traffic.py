"""The seeded corpus: the same seed gives the same bytes, every seed the same sizes."""

import numpy as np

from portbench import harness
from portbench.generator import UNLABELED, make_corpus

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


def _mix(cell="amazon-polarity-nomic128.fit"):
    _, cfg, mix, _, _ = harness.cell_spec(BENCH, cell)
    return dict(cfg, vertices=2000), mix


def test_same_seed_same_corpus():
    cfg, mix = _mix()
    a, b = make_corpus(cfg, mix, 2**31 + 17), make_corpus(cfg, mix, 2**31 + 17)
    assert a.x.tobytes() == b.x.tobytes() and a.y.tobytes() == b.y.tobytes()


def test_seeds_differ_in_data_not_in_sizes():
    cfg, mix = _mix()
    a, b = make_corpus(cfg, mix, 5), make_corpus(cfg, mix, 6)
    assert a.x.shape == b.x.shape == (2000, cfg["emb_dim"])
    assert a.x.dtype == np.float32 and a.y.dtype == np.int8
    assert not np.array_equal(a.x, b.x)
    for c in (a, b):
        seeds = c.y != UNLABELED
        assert seeds.sum() == round(mix["labeled_share"] * 2000)
        assert set(np.unique(c.y[seeds])) == {0, 1}
        assert (c.y[seeds] == c.cls[seeds]).all()  # seeds carry their true class
        assert (c.cls == 1).sum() == 1000  # the classes as balanced as the source's


def test_large_and_negative_seeds():
    cfg, mix = _mix()
    for s in (2**40 + 3, -7):
        c = make_corpus(cfg, mix, s)
        assert c.x.shape == (2000, cfg["emb_dim"])
