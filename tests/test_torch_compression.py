"""The port's int8 error-feedback gradient compression
(``repro_torch.training.resilience``) against the JAX package's.

The two compression tests of ``tests/test_resilience.py``, then
``compress``/``compress_tree`` bit for bit against the reference on seeded
fp32 and bf16 gradients over several steps of error feedback (codes,
scales and errors), and the compressed mean over an 8-shard CPU
``DeviceMesh`` equal to the mean of the decompressed trees, summed in
shard order, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import resilience as jres
from repro_torch.core.distributed import DeviceMesh
from repro_torch.models.convert import tensor_from_numpy
from repro_torch.training.resilience import (compress, compress_tree, decompress,
                                             decompress_tree, init_error_state,
                                             make_compressed_allreduce)

torch.set_num_threads(1)


def test_compression_error_feedback_preserves_mean():
    """Accumulated error feedback keeps the long-run compressed sum close to
    the true sum (the convergence-preserving property)."""
    rng = np.random.default_rng(0)
    g_true = [rng.normal(0, 1e-3, (64,)).astype(np.float32) for _ in range(50)]
    err = init_error_state({"w": torch.zeros(64)})
    total_q = np.zeros(64)
    for g in g_true:
        codes, scales, err = compress_tree({"w": torch.from_numpy(g)}, err)
        total_q += decompress_tree(codes, scales)["w"].numpy()
    total_true = np.sum(g_true, axis=0)
    # without error feedback the quantization bias would accumulate
    np.testing.assert_allclose(total_q, total_true, atol=5e-4)


def test_compressed_training_converges():
    """A linear-regression model trained with int8-compressed grads reaches
    the same loss region as uncompressed SGD."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0, 1, (256, 8)).astype(np.float32))
    y = x @ torch.from_numpy(rng.normal(0, 1, (8,)).astype(np.float32))

    def loss_fn(w):
        return torch.mean((x @ w - y) ** 2)

    def train(compressed):
        w = torch.zeros(8)
        err = init_error_state({"w": w})
        for _ in range(200):
            w_ = w.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(loss_fn(w_), [w_])
            if compressed:
                codes, scales, err = compress_tree({"w": g}, err)
                g = decompress_tree(codes, scales)["w"]
            w = w - 0.1 * g
        return float(loss_fn(w))

    assert train(True) < 1e-3
    assert abs(train(True) - train(False)) < 1e-3


def _grads(rng, step):
    """A seeded tree: an fp32 matrix, a bf16 vector, a nested fp32 leaf
    whose scale varies by step, and an all-zero leaf."""
    a = rng.normal(0, 1e-2 * (step + 1), (16, 24)).astype(np.float32)
    b = np.asarray(jnp.asarray(rng.normal(0, 1, (40,)), jnp.bfloat16))
    c = (rng.standard_t(2, (7, 5)) * 1e-4).astype(np.float32)
    return {"a": a, "nested": {"b": b, "c": c}, "z": np.zeros((3,), np.float32)}


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _same(got, want, what):
    if isinstance(want, dict):
        for k in want:
            _same(got[k], want[k], f"{what}/{k}")
        return
    w = np.asarray(want)
    g = got.numpy()
    assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype, w.dtype)
    assert np.array_equal(g.reshape(-1).view(np.uint8), w.reshape(-1).view(np.uint8)), what


def test_compress_tree_equals_the_reference_bitwise():
    rng = np.random.default_rng(5)
    grads0 = _grads(rng, 0)
    err = init_error_state(_map(tensor_from_numpy, grads0))
    jerr = jres.init_error_state(_map(jnp.asarray, grads0))
    for step in range(6):
        grads = grads0 if step == 0 else _grads(rng, step)
        codes, scales, err = compress_tree(_map(tensor_from_numpy, grads), err)
        jcodes, jscales, jerr = jres.compress_tree(_map(jnp.asarray, grads), jerr)
        _same(codes, jcodes, f"codes step {step}")
        _same(scales, jscales, f"scales step {step}")
        _same(err, jerr, f"error step {step}")
        _same(decompress_tree(codes, scales), jres.decompress_tree(jcodes, jscales),
              f"decompressed step {step}")
    # one leaf alone, with an error carried in
    g = rng.normal(0, 1, (100,)).astype(np.float32)
    e = rng.normal(0, 1e-3, (100,)).astype(np.float32)
    for got, want in zip(compress(torch.from_numpy(g), torch.from_numpy(e)),
                         jres.compress(jnp.asarray(g), jnp.asarray(e))):
        _same(got, want, "compress")
    q, s, _ = compress(torch.from_numpy(g), torch.from_numpy(e))
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    assert torch.equal(decompress(q, s), q.float() * s)


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_compressed_mean_over_the_mesh(shards):
    mesh = DeviceMesh.local(shards, device="cpu")
    rng = np.random.default_rng(shards)
    codes, scales = [], []
    for _ in range(shards):
        tree = _map(tensor_from_numpy, _grads(rng, 2))
        q, s, _ = compress_tree(tree, init_error_state(tree))
        codes.append(q)
        scales.append(s)
    out = make_compressed_allreduce(mesh)(codes, scales)
    assert len(out) == shards
    parts = [decompress_tree(q, s) for q, s in zip(codes, scales)]

    def mean(*leaves):
        total = leaves[0]
        for leaf in leaves[1:]:
            total = total + leaf
        return total / shards

    want = {"a": mean(*(p["a"] for p in parts)), "z": mean(*(p["z"] for p in parts)),
            "nested": {k: mean(*(p["nested"][k] for p in parts)) for k in ("b", "c")}}
    for got in out:
        for key in ("a", "z"):
            assert got[key].dtype == torch.float32 and torch.equal(got[key], want[key]), key
        for key in ("b", "c"):
            assert torch.equal(got["nested"][key], want["nested"][key]), key
    with pytest.raises(ValueError, match="shards"):
        make_compressed_allreduce(mesh)(codes[:-1] if shards > 1 else [], scales)
