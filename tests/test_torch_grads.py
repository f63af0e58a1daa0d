"""The port's LM gradients (autograd through ``TransformerLM.loss``)
against ``jax.value_and_grad`` of the reference's ``loss``, on the
reference's ``init`` carried across by ``lm_params_from_jax``, for each
dense smoke config (qwen3, yi, deepseek, h2o).  Tolerances:

- fp32 (both trees cast): the loss within 1e-5 (measured 9.5e-7) and every
  leaf's gradient within 1e-4 of the leaf's largest |g| (measured ≤ 1.0e-6
  of it), with
  the dense attention and with the chunked one (q_chunk 8, k_chunk 16 at
  S = 32, so the online-softmax backward runs over 4 × 2 chunk pairs).
- bf16 (as configured): the loss within 0.02 (measured 0.0020), per leaf
  ||Δg|| / ||g|| within 0.05 (measured ≤ 0.0154): torch rounds every bf16
  op's output, XLA a fused chain once.
- ``remat="full"`` against ``"none"`` in the port: every gradient bit for
  bit (the backward recomputes each layer from its input with the same
  ops).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import registry
from repro_torch.models.api import build_model
from repro_torch.models.convert import lm_params_from_jax, to_tree

torch.set_num_threads(1)

DENSE = ["qwen3_0_6b", "yi_6b", "deepseek_67b", "h2o_danube_3_4b"]
CHUNKED = dict(attn_impl="chunked", q_chunk=8, k_chunk=16)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _batch(cfg, seed=1, b=2, s=32):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _port_grads(model, toks, labels):
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss, _ = model.loss({"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), to_tree(dict(zip(params, grads)))


def _pair(name, prec, **over):
    jcfg = dataclasses.replace(jreg.get_smoke_config(name), **over)
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    if prec == "fp32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    cfg = dataclasses.replace(registry.get_smoke_config(name), **over)
    model = lm_params_from_jax(build_model(cfg, device="cpu"), jax.tree.map(np.asarray, params))
    return jcfg, params, model


def _leaves(tree, want):
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = tree
        for k in path:
            node = node[k.key]
        yield jax.tree_util.keystr(path), _np(node), _np(w)


@pytest.mark.parametrize("attn", ["dense", "chunked"])
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("name", DENSE)
def test_gradients_equal_the_reference(name, prec, attn):
    jcfg, params, model = _pair(name, prec, **(CHUNKED if attn == "chunked" else {}))
    toks, labels = _batch(jcfg)
    jm = jax_build_model(jcfg)
    (want_loss, _), want = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    loss, got = _port_grads(model, toks, labels)
    assert abs(loss - float(want_loss)) <= (1e-5 if prec == "fp32" else 0.02)
    for path, g, w in _leaves(got, want):
        assert g.shape == w.shape, path
        if prec == "fp32":
            err = np.abs(g - w).max()
            assert err <= 1e-4 * np.abs(w).max(), (path, err, np.abs(w).max())
        else:
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert rel <= 0.05, (path, rel)


@pytest.mark.parametrize("attn", ["dense", "chunked"])
@pytest.mark.parametrize("name", DENSE)
def test_remat_changes_no_gradient(name, attn):
    over = CHUNKED if attn == "chunked" else {}
    _, _, full = _pair(name, "bf16", remat="full", **over)
    _, _, none = _pair(name, "bf16", remat="none", **over)
    toks, labels = _batch(full.cfg, seed=2)
    calls = {"full": 0, "none": 0}
    for key, model in (("full", full), ("none", none)):
        def counted(*a, key=key, forward=model.layers[0].forward):
            calls[key] += 1
            return forward(*a)
        model.layers[0].forward = counted
    loss_full, g_full = _port_grads(full, toks, labels)
    loss_none, g_none = _port_grads(none, toks, labels)
    assert calls == {"full": 2, "none": 1}  # the backward ran layer 0 again
    assert loss_full == loss_none
    _bitwise(g_full, g_none, "")


def _bitwise(a, b, key):
    if isinstance(a, dict):
        for k in a:
            _bitwise(a[k], b[k], f"{key}/{k}")
        return
    assert torch.equal(a, b), key
