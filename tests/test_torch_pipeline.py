"""The port's DynLP pseudo-label pipeline (``repro_torch.data.pipeline``).

Mirrors ``tests/test_serving.py::test_pipeline_pseudo_labels`` against the
port's pipeline, then holds it to the reference's over three waves of
documents: ``default_embed`` bitwise (the same numpy function), the graph's
arrays byte for byte after every wave (the same host kNN), F within 20·δ
(the reference's bound between its own backends: XLA and torch sum a row's
lanes in different orders) and ``select``'s ids equal wherever F lies
further than 20·δ from the confidence threshold.  The documents come from
``data.synth.make_documents``, held here to the reference example's own
generator.
"""

import pathlib
import runpy

import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipeline
from repro.graph.dynamic import UNLABELED as JAX_UNLABELED
from repro_torch.data.pipeline import PseudoLabelPipeline, default_embed
from repro_torch.data.synth import make_documents
from repro_torch.graph.dynamic import UNLABELED

torch.set_num_threads(1)

DELTA = 1e-4
F_TOL = 20 * DELTA
EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
GRAPH = ("src", "dst", "wgt", "knn_idx", "knn_wgt", "alive", "labels")


def test_pipeline_pseudo_labels():
    rng = np.random.default_rng(0)
    pipe = PseudoLabelPipeline(k=3, device="cpu")
    n, s, vocab = 120, 32, 97
    cls = rng.integers(0, 2, n).astype(np.int8)
    toks = np.zeros((n, s), np.int32)
    base = rng.integers(0, vocab, (n, 1))
    toks[cls == 1] = (base[cls == 1] + np.arange(s)) % vocab
    toks[cls == 0] = rng.integers(0, vocab, ((cls == 0).sum(), s))
    labels = np.full(n, UNLABELED, np.int8)
    labels[:6] = cls[:6]
    pipe.ingest(toks, labels)
    truth = {i: int(c) for i, c in enumerate(cls)}
    assert pipe.label_quality(truth) > 0.9
    ids, curated = pipe.select(target_class=1, confidence=0.7)
    assert len(ids) > 10
    purity = np.mean([truth[i] == 1 for i in ids])
    assert purity > 0.9


def test_pipeline_needs_a_device_or_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PseudoLabelPipeline()


def test_make_documents_is_the_examples():
    ns = runpy.run_path(str(EXAMPLES / "semi_supervised_lm.py"))  # defines, runs nothing
    for vocab in (128, 151_936):
        got = make_documents(np.random.default_rng(vocab), 200, 64, vocab)
        want = ns["make_documents"](np.random.default_rng(vocab), 200, 64, vocab)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("vocab", [128, 151_936])
def test_default_embed_bitwise(vocab):
    toks = make_documents(np.random.default_rng(vocab), 300, 64, vocab)[0]
    for dim in (32, 16):
        assert np.array_equal(default_embed(toks, dim).view(np.int32),
                              jpipeline.default_embed(toks, dim).view(np.int32))


@pytest.mark.parametrize("vocab", [128, 151_936])
def test_pipeline_against_the_reference(vocab):
    assert UNLABELED == JAX_UNLABELED
    rng = np.random.default_rng(7)
    ours = PseudoLabelPipeline(k=5, delta=DELTA, device="cpu")
    ref = jpipeline.PseudoLabelPipeline(k=5, delta=DELTA)
    truth = {}
    for wave in range(3):
        toks, labels, cls = make_documents(rng, 300, 64, vocab)
        drop = (np.flatnonzero(ours.graph.alive)[::37] if wave == 2
                else None)  # the last wave deletes some documents too
        base = ours.graph.num_nodes
        got = ours.ingest(toks, labels, drop_ids=drop)
        want = ref.ingest(toks, labels, drop_ids=drop)
        truth.update({base + i: int(c) for i, c in enumerate(cls)})
        assert got.num_docs == want.num_docs == 300
        assert got.lp_iterations > 0
        for name in GRAPH:
            a, b = getattr(ours.graph, name), getattr(ref.graph, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), (wave, name)
        assert np.abs(ours.graph.f - ref.graph.f).max() <= F_TOL, wave
    assert ours.docs.keys() == ref.docs.keys()
    quality = ours.label_quality(truth)
    assert abs(quality - ref.label_quality(truth)) <= 5 / len(truth)
    f = ours.graph.f
    for target, conf in ((1, 0.7), (0, 0.8), (1, 0.5)):
        ids, curated = ours.select(target, conf)
        ref_ids, ref_curated = ref.select(target, conf)
        score = f if target == 1 else 1.0 - f
        far = np.abs(score - conf) > F_TOL
        assert np.array_equal(np.intersect1d(ids, np.flatnonzero(far)),
                              np.intersect1d(ref_ids, np.flatnonzero(far)))
        assert curated.shape == (len(ids), 64)
        if len(ids) and np.array_equal(ids, ref_ids):
            assert np.array_equal(curated, ref_curated)
    limited, _ = ours.select(1, 0.7, limit=5)
    assert np.array_equal(limited, ours.select(1, 0.7)[0][:5])
