"""The port's ``DynLabelPropagation``, the sklearn-style front door.

Mirrors ``tests/test_estimator.py`` (params round-trip and re-instantiation
from ``get_params``, fitted attributes, transductive and inductive accuracy
on separable gaussians, ``partial_fit`` / ``forget`` / ``relabel``, host
and device ingest bit-identical), on the CPU; then the port's estimator
against the JAX package's on the same data, with host and device ingest:
the same graph bytes, labels within 20·δ and the same predictions.
"""

import numpy as np
import pytest
import torch

from repro.serving.estimator import DynLabelPropagation as JaxDynLabelPropagation
from repro_torch.serving.estimator import UNLABELED, DynLabelPropagation

torch.set_num_threads(1)

DELTA = 1e-4


CPU = {"device": "cpu"}


def _clf(**kw):
    return DynLabelPropagation(engine_opts=CPU, **kw)


def _blobs(rng, n, d=8, sep=2.5, noise=0.7):
    X = np.concatenate([rng.normal(-sep, noise, (n // 2, d)),
                        rng.normal(+sep, noise, (n - n // 2, d))]).astype(np.float32)
    truth = np.repeat([0, 1], [n // 2, n - n // 2]).astype(np.int8)
    return X, truth


def _seeded(truth, n_seeds, rng):
    y = np.full(len(truth), UNLABELED, np.int8)
    for c in (0, 1):
        ids = rng.choice(np.flatnonzero(truth == c), n_seeds, replace=False)
        y[ids] = c
    return y


def test_params_roundtrip_and_clone():
    clf = _clf(k=7, delta=1e-3, ingest="host")
    p = clf.get_params()
    assert p["k"] == 7 and p["delta"] == 1e-3 and p["ingest"] == "host"
    assert p["engine_opts"] == CPU
    clone = DynLabelPropagation(**p)  # what sklearn.clone does
    assert clone.get_params() == p
    clone.set_params(k=3)
    assert clone.k == 3 and clf.k == 7
    with pytest.raises(ValueError, match="invalid parameter"):
        clone.set_params(nope=1)


def test_fit_transductive_accuracy():
    rng = np.random.default_rng(0)
    X, truth = _blobs(rng, 240)
    y = _seeded(truth, 4, rng)
    clf = _clf(k=5).fit(X, y)
    assert clf.n_features_in_ == 8
    assert np.array_equal(clf.classes_, [0, 1])
    assert len(clf.transduction_) == len(X)
    assert (clf.transduction_ != UNLABELED).all()
    assert (clf.transduction_ == truth).mean() > 0.95
    seeds = y != UNLABELED  # seeds are reproduced exactly
    np.testing.assert_array_equal(clf.transduction_[seeds], y[seeds])


def test_predict_inductive_without_growing_the_graph():
    rng = np.random.default_rng(1)
    X, truth = _blobs(rng, 200)
    clf = _clf(k=5).fit(X, _seeded(truth, 4, rng))
    n0 = clf.graph_.num_alive
    Xq, tq = _blobs(rng, 40)
    pred = clf.predict(Xq)
    assert clf.graph_.num_alive == n0  # probe points removed again
    assert (pred == tq).mean() > 0.9
    assert clf.score(Xq, tq) > 0.9


def test_partial_fit_streams_and_first_call_fits():
    rng = np.random.default_rng(2)
    X, truth = _blobs(rng, 160)
    y = _seeded(truth, 4, rng)
    clf = _clf(k=5)
    clf.partial_fit(X[:80], y[:80])  # the first call behaves like fit
    assert clf.graph_.num_alive == 80
    clf.partial_fit(X[80:], y[80:])
    assert clf.graph_.num_alive == 160
    assert (clf.transduction_ == truth).mean() > 0.95


def test_forget_and_relabel():
    rng = np.random.default_rng(3)
    X, truth = _blobs(rng, 120)
    y = _seeded(truth, 3, rng)
    clf = _clf(k=4).fit(X, y)
    clf.forget(np.arange(5))
    assert clf.graph_.num_alive == 115
    assert clf.transduction_[0] == UNLABELED  # dead ids read UNLABELED
    sid = int(np.flatnonzero(y == 0)[-1])
    clf.relabel([sid], [1])
    assert clf.transduction_[sid] == 1  # seed flipped, committed


def test_host_and_device_ingest_bit_identical():
    rng = np.random.default_rng(4)
    X, truth = _blobs(rng, 150)
    y = _seeded(truth, 4, rng)
    a = _clf(k=5, ingest="device").fit(X, y)
    b = _clf(k=5, ingest="host").fit(X, y)
    np.testing.assert_array_equal(a.transduction_, b.transduction_)
    np.testing.assert_array_equal(a.graph_.f, b.graph_.f)


def test_input_validation():
    clf = _clf()
    with pytest.raises(ValueError, match="2-D"):
        clf.fit(np.zeros(8, np.float32))


@pytest.mark.parametrize("ingest", ["host", "device"])
def test_estimator_matches_reference_estimator(ingest):
    """fit, partial_fit, forget, relabel and predict through both
    estimators on the same data: graph bytes equal after every verb,
    labels within 20·δ, the same transductive and inductive predictions."""
    rng = np.random.default_rng(5)
    X, truth = _blobs(rng, 200)
    y = _seeded(truth, 4, rng)
    Xq, tq = _blobs(rng, 30)
    j = JaxDynLabelPropagation(k=5, ingest=ingest, delta=DELTA,
                               engine_opts={"backend": "ref"})
    t = _clf(k=5, ingest=ingest, delta=DELTA)

    def check():
        jg, tg = j.graph_, t.graph_
        for name in ("src", "dst", "wgt", "knn_idx", "knn_wgt", "alive", "labels"):
            assert getattr(jg, name).tobytes() == getattr(tg, name).tobytes(), name
        unl = np.flatnonzero(tg.alive & (tg.labels == UNLABELED))
        assert np.abs(jg.f[unl] - tg.f[unl]).max(initial=0) <= 20 * DELTA
        np.testing.assert_array_equal(np.asarray(j.transduction_), t.transduction_)

    for est in (j, t):
        est.fit(X[:120], y[:120])
    check()
    for est in (j, t):
        est.partial_fit(X[120:], y[120:])
    check()
    for est in (j, t):
        est.forget(np.arange(0, 200, 17))
        est.relabel([int(np.flatnonzero(y == 1)[0])], [0])
    check()
    jp, tp = j.predict(Xq), t.predict(Xq)
    np.testing.assert_array_equal(np.asarray(jp), tp)
    check()
    assert t.score(Xq, tq) == j.score(Xq, tq) > 0.9
