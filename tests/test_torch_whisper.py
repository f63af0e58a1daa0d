"""The port's ``audio`` family, Whisper (``EncDecModel`` of
``models/encdec.py``, the biased and bidirectional ``Attention`` of
``models/blocks.py`` with its ``cross_attn`` and ``memory_kv``), against
the JAX package's ``repro.models.encdec.EncDecModel`` on whisper-medium's
smoke config (2 encoder and 2 decoder layers, d_model 64), the reference's
``init`` carried across and the same seeded inputs.  The reference
zero-inits the biases and one-inits the norm scales; here every bias, norm
scale and ``frontend_proj`` is set to seeded non-zero values in both
packages, so a missing or misplaced bias shows.  Tolerances:

- The attention block (bidirectional with no rotation, causal with RoPE,
  one decode step against a cache, ``memory_kv`` and ``cross_attn``) and the
  GELU MLP on the same input: fp32 within 1e-5 of the output's largest |y|
  (measured ≤ 2.9e-7); bf16 within 2^-7 of it (measured ≤ 0.0035, one bf16
  ULP of the largest output: XLA rounds the GELU's chain once, torch every
  op).
- The smoke model in fp32 (every leaf upcast; the decode cache stays bf16):
  ``encode`` and ``_decoder`` within 1e-5 of the states' largest |h|
  (measured ≤ 3.2e-7), ``prefill``'s logits within 1e-4 (measured 7.2e-7),
  ``loss`` within 1e-5; ``prefill``'s bf16 cache within one bf16 ULP of its
  value (an fp32 value a hair from a rounding boundary rounds the other way
  in one package).  20 ``decode_step``s from
  the prefill's cache, each on the reference's own cache and as the port's
  own chain: logits within 1e-4, or within ``FLIPPED_TOL`` once a bf16
  cache element (the step's own k or v, or an earlier one) rounded
  otherwise (measured ≤ 5.6e-4).
- In bf16 (as configured): the loss within 0.02 (measured 0.0018), logits
  within 0.1 (the dense LM's bound in ``tests/test_torch_lm.py``; measured
  ≤ 0.031), the encoder's and decoder's states within 2^-6 of their
  largest |h| (measured ≤ 0.0101, two bf16 ULPs), the cache within 2^-5 of
  each leaf's largest |x| (measured ≤ 0.0082).
- The decode chain against the teacher-forced decoder over the same tokens
  and the same encoding: in fp32 within 2e-2, since the cache keeps the
  cross memory and the self k and v in bf16 where the forward keeps fp32
  (measured 6.5e-3); in bf16 within 0.15 (``tests/test_arch_smoke.py``'s
  bound for prefill against a decode chain; measured 0).
- Gradients against ``jax.value_and_grad``: fp32 within 1e-4 of the leaf's
  largest |g| (measured ≤ 2.6e-6); bf16 against the reference's fp32
  gradients within 0.05 plus twice the reference's own bf16 gap on that
  leaf, relative norms (measured: the port ≤ 0.028, the reference ≤ 0.029);
  the ``bk`` leaves whose gradient is zero in exact arithmetic as
  ``ZERO_GRAD`` says.  ``remat`` on and off: bit for bit.
- ``tests/test_arch_smoke.py``'s four checks for the whisper smoke config,
  on the port's model.  The reference skips the fourth for enc-dec; here it
  is the chain from ``prefill`` against the teacher-forced forward (0.15).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import blocks as jblocks
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import registry
from repro_torch.launch.specs import make_batch
from repro_torch.models.api import build_model
from repro_torch.models.blocks import MLP, Attention
from repro_torch.models.common import ShapeSpec
from repro_torch.models.convert import (cache_from_jax, cache_to_tree, lm_params_from_jax,
                                        tensor_from_numpy, to_tree)
from repro_torch.models.encdec import DEC_FRAC, DEC_MAX, EncDecModel

torch.set_num_threads(1)

NAME = "whisper_medium"
BLOCK_TOL = {"fp32": 1e-5, "bf16": 2.0 ** -7}  # relative to the output's largest |y|
LOGIT_TOL = {"fp32": 1e-4, "bf16": 0.1}
HIDDEN_TOL = {"fp32": 1e-5, "bf16": 2.0 ** -6}  # relative to the states' largest |h|
LOSS_TOL = {"fp32": 1e-5, "bf16": 0.02}
CACHE_TOL = 2.0 ** -5  # bf16: relative to the leaf's largest |x|
FLIPPED_TOL = 2e-2
CHAIN_TOL = {"fp32": 2e-2, "bf16": 0.15}  # the decode chain vs the teacher-forced decoder
# The gradient of ``bk`` where no rotation follows it (the encoder's
# attention, the cross attention) is zero in exact arithmetic: it adds
# q·bk to every score of a query, which the softmax takes away.  Both
# packages give rounding noise there, held within ZERO_TOL of the largest
# |g| of any leaf (measured: fp32 ≤ 1.7e-8, bf16 ≤ 4.0e-4, the reference's).
ZERO_GRAD = ("['enc_layers']['attn']['bk']", "['dec_layers']['xattn']['bk']")
ZERO_TOL = {"fp32": 1e-6, "bf16": 2e-3}
# the flat cache's keys in the order of the reference's nested tree's leaves
CACHE_KEYS = ("cross_k", "cross_v", "self_k", "self_v")
FRAMES, STEPS = 64, 20
BIASES = ("bq", "bk", "bv", "bo", "b1", "b2")
SCALES = ("ln1", "ln2", "ln3", "enc_norm", "final_norm")


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _t(a):
    return tensor_from_numpy(np.asarray(a))


def _gap(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) if got.size else 0.0


def _close(got, want, tol, what):
    diff = _gap(got, want)
    assert diff <= tol, f"{what}: max|diff| {diff} > {tol}"
    return diff


def _rel_close(got, want, prec, what):
    scale = float(np.abs(_np(want)).max()) or 1.0
    rel = _gap(got, want) / scale
    assert rel <= BLOCK_TOL[prec], f"{what}: {rel} of its scale > {BLOCK_TOL[prec]}"
    return rel


def _hidden_close(got, want, prec, what):
    scale = float(np.abs(_np(want)).max())
    rel = _gap(got, want) / scale
    assert rel <= HIDDEN_TOL[prec], f"{what}: {rel} of its scale > {HIDDEN_TOL[prec]}"
    return rel


def _cast(tree, prec):
    return jax.tree.map(lambda a: a.astype(jnp.float32), tree) if prec == "fp32" else tree


def _seeded(tree, seed):
    """``tree`` with every bias, norm scale and ``frontend_proj`` drawn from
    ``seed``: biases N(0, 0.1²), scales 1 + N(0, 0.1²), ``frontend_proj``
    N(0, 1/fan_in), each in its leaf's dtype."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        key = path[-1].key
        if key in BIASES:
            x = rng.normal(0, 0.1, a.shape)
        elif key in SCALES:
            x = 1 + rng.normal(0, 0.1, a.shape)
        elif key == "frontend_proj":
            x = rng.normal(0, 1 / np.sqrt(a.shape[0]), a.shape)
        else:
            return a
        return jnp.asarray(x.astype(np.float32), a.dtype)
    return jax.tree_util.tree_map_with_path(draw, tree)


def _input(rng, shape, prec, scale=1.0):
    x = (rng.normal(0, 1, shape) * scale).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16) if prec == "bf16" else jnp.asarray(x)


def _load(module, tree):
    for name, arr in jax.tree_util.tree_flatten_with_path(tree)[0]:
        getattr(module, name[-1].key).data = _t(arr).clone()
    return module


def _leaves(module):
    return {n: (tuple(p.shape), p.dtype) for n, p in module.named_parameters()}


def _ref_leaves(tree):
    return {n: (a.shape, _t(a).dtype) for n, a in tree.items()}


# --------------------------------------------------------------------- #
# the blocks on the same input
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_attention_block(prec):
    """The biased ``Attention`` (leaves ``attn_init(bias=True)``'s) against
    ``attn_apply`` bidirectional with no rotation (the encoder's) and causal
    with RoPE (the decoder's), ``attn_decode`` with a scalar and a per-slot
    ``pos`` (``bo`` added), ``memory_kv_init`` and ``cross_attn_apply``."""
    cfg, jcfg = registry.get_smoke_config(NAME), jreg.get_smoke_config(NAME)
    p = _cast(_seeded(jblocks.attn_init(jax.random.PRNGKey(3), jcfg, bias=True), 4), prec)
    fresh = Attention(cfg, torch.Generator().manual_seed(0), bias=True)
    assert _leaves(fresh) == _ref_leaves(jblocks.attn_init(jax.random.PRNGKey(3), jcfg,
                                                           bias=True))
    assert set(_leaves(Attention(cfg, torch.Generator()))) == {"wq", "wk", "wv", "wo"}
    block = _load(fresh, p)
    rng = np.random.default_rng(7)
    x = _input(rng, (2, 16, cfg.d_model), prec)
    pos = jnp.broadcast_to(jnp.arange(16, dtype=jnp.int32), (2, 16))
    worst = 0.0
    with torch.no_grad():
        for positions, causal in ((None, False), (pos, True)):
            y, (k, v) = block(_t(x), None if positions is None else _t(positions),
                              causal=causal)
            jy, (jk, jv) = jblocks.attn_apply(p, x, jcfg, positions=positions, causal=causal)
            for got, want, what in ((y, jy, "y"), (k, jk, "k"), (v, jv, "v")):
                assert got.dtype == _t(want).dtype
                worst = max(worst, _rel_close(got, want, prec, f"{what}, causal={causal}"))
        memory = _input(rng, (2, 20, cfg.d_model), prec)
        mk, mv = block.memory_kv(_t(memory))
        jmk, jmv = jblocks.memory_kv_init(p, memory, jcfg)
        worst = max(worst, _rel_close(mk, jmk, prec, "memory k"), _rel_close(mv, jmv, prec,
                                                                              "memory v"))
        y = block.cross_attn(_t(x), (mk, mv))
        worst = max(worst, _rel_close(y, jblocks.cross_attn_apply(p, x, jcfg, (jmk, jmv)), prec,
                                      "cross attention"))
        shape = (2, 24, cfg.n_kv_heads, cfg.hd)
        cache = {key: _input(rng, shape, prec, 0.5) for key in ("k", "v")}
        x1 = _input(rng, (2, 1, cfg.d_model), prec)
        for step_pos in (np.int32(9), np.array([9, 4], np.int32)):
            k, v = _t(cache["k"]).clone(), _t(cache["v"]).clone()
            y = block.decode(_t(x1), k, v, torch.as_tensor(step_pos).long())
            jy, jnew = jblocks.attn_decode(p, x1, jcfg, cache, jnp.asarray(step_pos))
            worst = max(worst, _rel_close(y, jy, prec, f"decode at {step_pos}"),
                        _rel_close(k, jnew["k"], prec, "decode k"),
                        _rel_close(v, jnew["v"], prec, "decode v"))
    print(f"{prec}: worst {worst}")


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_gelu_mlp_block(prec):
    """``MLP(gelu=True)``'s leaves are ``mlp_init(gelu=True)``'s, and with
    non-zero biases its output is ``mlp_apply``'s."""
    cfg, jcfg = registry.get_smoke_config(NAME), jreg.get_smoke_config(NAME)
    p = _cast(_seeded(jblocks.mlp_init(jax.random.PRNGKey(5), jcfg, gelu=True), 6), prec)
    fresh = MLP(cfg, torch.Generator().manual_seed(0), gelu=True)
    assert _leaves(fresh) == _ref_leaves(jblocks.mlp_init(jax.random.PRNGKey(5), jcfg, gelu=True))
    x = _input(np.random.default_rng(8), (2, 16, cfg.d_model), prec)
    with torch.no_grad():
        y = _load(fresh, p)(_t(x))
    assert y.dtype == _t(x).dtype
    print(f"{prec}: {_rel_close(y, jblocks.mlp_apply(p, x), prec, 'gelu mlp')}")


# --------------------------------------------------------------------- #
# the smoke model on the reference's init
# --------------------------------------------------------------------- #
def _pair(prec, **over):
    jcfg = dataclasses.replace(jreg.get_smoke_config(NAME), **over)
    params = _cast(_seeded(jax_build_model(jcfg).init(jax.random.PRNGKey(0)), 1), prec)
    cfg = dataclasses.replace(registry.get_smoke_config(NAME), **over)
    model = lm_params_from_jax(build_model(cfg, device="cpu"), jax.tree.map(np.asarray, params))
    return jcfg, params, model


def _frames(cfg, seed, b=2, s=FRAMES):
    """Seeded frame embeddings in bf16, as ``make_batch`` gives them."""
    x = np.random.default_rng(seed).normal(0, 1, (b, s, cfg.frontend_dim)).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16)


def _tokens(cfg, seed, b=2, s=FRAMES // DEC_FRAC):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _cache_close(got, want, prec):
    """The port's flat cache against the reference's nested tree: fp32,
    every leaf (bf16) within one bf16 ULP of its value; bf16, within
    ``CACHE_TOL`` of its largest |x|.  Returns the worst relative gap."""
    worst = 0.0
    assert len(jax.tree.leaves(want)) == len(CACHE_KEYS)
    for key, w in zip(CACHE_KEYS, jax.tree.leaves(want)):
        g = got[key]
        assert g.dtype == _t(w).dtype == torch.bfloat16, key
        if prec == "fp32":
            np.testing.assert_allclose(_np(g), _np(w), rtol=2.0 ** -7, atol=1e-6, err_msg=key)
        else:
            scale = float(np.abs(_np(w)).max()) or 1.0
            worst = max(worst, _close(g, w, CACHE_TOL * scale, key) / scale)
    return worst


def _flipped(cache, jcache):
    return any(not np.array_equal(_np(cache[key]), _np(w))
               for key, w in zip(CACHE_KEYS, jax.tree.leaves(jcache)))


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_model_against_the_reference(prec):
    """``encode``, ``_decoder``, the logits and ``loss`` of the smoke model
    on 2 x 64 frames and 8 decoder tokens; ``prefill``'s logits and cache
    (the self cache ``DEC_MAX`` long, token 0 written at position 0); then
    20 ``decode_step``s (scalar ``pos`` on even steps, a per-slot vector on
    odd ones), each on the reference's own cache and as the port's chain,
    and the chain against the teacher-forced decoder over the same tokens
    and the same encoding."""
    jcfg, params, model = _pair(prec)
    jm = jax_build_model(jcfg)
    frames, toks = _frames(jcfg, 1), _tokens(jcfg, 2)
    labels = np.roll(toks, -1, axis=1)
    positions = jnp.broadcast_to(jnp.arange(toks.shape[1], dtype=jnp.int32), toks.shape)
    with torch.no_grad():
        memory = model.encode(_t(frames))
        hidden = model._decoder(_t(toks), memory, _t(positions))
        logits = model(_t(toks), _t(frames))
        loss, metrics = model.loss({"frames": _t(frames), "tokens": _t(toks),
                                    "labels": _t(labels)})
    jmemory = jax.jit(jm.encode)(params, frames)
    gaps = {"encode": _hidden_close(memory, jmemory, prec, "encode")}
    jhidden = jax.jit(jm._decoder)(params, jnp.asarray(toks), jmemory, positions)
    gaps["decoder"] = _hidden_close(hidden, jhidden, prec, "decoder")
    with torch.no_grad():
        same = model._decoder(_t(toks), _t(jmemory), _t(positions))
    gaps["decoder on the same memory"] = _hidden_close(same, jhidden, prec,
                                                       "decoder on the reference's memory")
    jloss, _ = jax.jit(jm.loss)(params, {"frames": frames, "tokens": jnp.asarray(toks),
                                         "labels": jnp.asarray(labels)})
    assert set(metrics) == {"xent"}
    gaps["loss"] = _close(loss, jloss, LOSS_TOL[prec], "loss")
    with torch.no_grad():
        want_loss = torch.nn.functional.cross_entropy(logits.float().reshape(-1, jcfg.vocab),
                                                      _t(labels).long().reshape(-1))
    _close(loss, want_loss, 1e-5, "loss vs the logits' cross entropy")
    # prefill: encode, the cross k and v, token 0 decoded at position 0
    jlog, jcache = jax.jit(jm.prefill)(params, {"frames": frames})
    with torch.no_grad():
        plog, cache = model.prefill({"frames": _t(frames)})
        first = model(torch.zeros((2, 1), dtype=torch.int64), _t(frames))
    assert plog.shape == (2, 1, jcfg.vocab)
    assert cache["self_k"].shape[2] == DEC_MAX and cache["cross_k"].shape[2] == FRAMES
    gaps["prefill"] = _close(plog, jlog, LOGIT_TOL[prec], "prefill logits")
    gaps["prefill cache"] = _cache_close(cache, jcache, prec)
    _close(first, plog, CHAIN_TOL[prec], "prefill vs the teacher-forced forward of token 0")
    dec = jax.jit(jm.decode_step)
    chain_toks = _tokens(jcfg, 3, s=STEPS)
    rows, step_gap, chain_gap, flipped = [plog], 0.0, 0.0, False
    for t in range(STEPS):
        pos = np.int32(t + 1) if t % 2 == 0 else np.full(2, t + 1, np.int32)
        tok = chain_toks[:, t:t + 1]
        batch = {"tokens": _t(tok).long(), "pos": torch.as_tensor(pos).long()}
        own = cache_from_jax(model, jax.tree.map(np.asarray, jcache))
        jlog, jcache = dec(params, jcache, {"tokens": jnp.asarray(tok), "pos": jnp.asarray(pos)})
        before = {k: v.clone() for k, v in cache.items()}
        with torch.no_grad():
            slog, snew = model.decode_step(own, batch)
            dlog, new = model.decode_step(cache, batch)
        assert all(torch.equal(before[k], cache[k]) for k in cache)  # the input is not written
        assert new["cross_k"] is cache["cross_k"] and new["cross_v"] is cache["cross_v"]
        cache = new
        # the step's own k or v may round to the other bf16 neighbour
        tol = FLIPPED_TOL if prec == "fp32" and _flipped(snew, jcache) else LOGIT_TOL[prec]
        step_gap = max(step_gap, _close(slog, jlog, tol, f"step {t}"))
        tol = FLIPPED_TOL if flipped and prec == "fp32" else LOGIT_TOL[prec]
        chain_gap = max(chain_gap, _close(dlog, jlog, tol, f"chain step {t}"))
        if prec == "bf16" or not flipped:
            _cache_close(cache, jcache, prec)
        flipped = flipped or _flipped(cache, jcache)
        rows.append(dlog)
    # the chain against the teacher-forced decoder over token 0 and the chain's tokens
    forced = np.concatenate([np.zeros((2, 1), np.int32), chain_toks], axis=1)
    with torch.no_grad():
        want = model(_t(forced), _t(frames))
    gaps["chain vs teacher-forced"] = _close(torch.cat(rows, 1), want, CHAIN_TOL[prec],
                                             "the chain vs the teacher-forced decoder")
    gaps.update(step=step_gap, chain=chain_gap, flipped=flipped)
    print(f"{prec}: {gaps}; logits max |x| {float(logits.abs().max()):.3f}")


def test_cache_shape_is_the_references():
    """``cache_shape``: the self k and v ``DEC_MAX`` long whatever ``s_max``,
    the cross k and v ``s_max`` long, ``(n_layers, B, S, Hkv, hd)`` bf16, in
    the reference's nested layout."""
    jcfg, _, model = _pair("bf16")
    assert (DEC_FRAC, DEC_MAX) == (8, 1024)
    for b, s in ((3, 24), (1, 1500)):
        want = jax_build_model(jcfg).cache_shape(b, s)
        shapes = model.cache_shape(b, s)
        assert cache_to_tree(model, shapes).keys() == want.keys()
        for key, w in zip(CACHE_KEYS, jax.tree.leaves(want)):
            assert tuple(shapes[key].shape) == w.shape, key
            assert str(shapes[key].dtype).split(".")[-1] == str(w.dtype), key
        assert shapes["self_k"].shape[2] == DEC_MAX and shapes["cross_k"].shape[2] == s


def _port_grads(model, batch):
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss, _ = model.loss({k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), to_tree(dict(zip(params, grads)))


def _grad_leaves(tree, want):
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = tree
        for k in path:
            node = node[k.key]
        yield jax.tree_util.keystr(path), _np(node), _np(w)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _batch(jcfg, seed):
    toks = _tokens(jcfg, seed)
    return {"frames": _frames(jcfg, seed), "tokens": toks, "labels": np.roll(toks, -1, axis=1)}


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_gradients_equal_the_reference(prec):
    """Every leaf's gradient, the encoder's, the biases' and
    ``frontend_proj``'s included.  fp32: within 1e-4 of its largest |g| of
    the reference's.  bf16: each port leaf held to the reference's fp32
    gradient within 0.05 plus twice the reference's own bf16 gap on that
    leaf."""
    jcfg, params, model = _pair(prec)
    batch = _batch(jcfg, 4)
    jm = jax_build_model(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    grad_fn = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))
    (want_loss, _), want = grad_fn(params, jbatch)
    loss, got = _port_grads(model, batch)
    assert abs(loss - float(want_loss)) <= LOSS_TOL[prec]
    scale = max(float(np.abs(_np(w)).max()) for w in jax.tree.leaves(want))
    worst = {}
    for path, g, w in _grad_leaves(got, want):
        if path in ZERO_GRAD:  # rounding noise in both packages
            assert max(np.abs(g).max(), np.abs(w).max()) <= ZERO_TOL[prec] * scale, path
    if prec == "fp32":
        for path, g, w in _grad_leaves(got, want):
            if path in ZERO_GRAD:
                continue
            assert g.shape == w.shape, path
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err <= 1e-4, (path, err)
            worst[path] = float(err)
    else:
        _, want32 = grad_fn(_cast(params, "fp32"), jbatch)
        for (path, g, w32), (_, w, _) in zip(_grad_leaves(got, want32),
                                             _grad_leaves(want, want32)):
            if path in ZERO_GRAD:
                continue
            port, ref = _rel(g, w32), _rel(w, w32)
            assert port <= 0.05 + 2 * ref, (path, port, ref)
            worst[path] = (round(port, 4), round(ref, 4), round(_rel(g, w), 4))
    assert {"['enc_layers']['attn']['bq']", "['dec_layers']['xattn']['bo']",
            "['frontend_proj']", "['enc_norm']"} <= set(worst)
    print(f"{prec}: {sorted(worst.items(), key=lambda kv: kv[1], reverse=True)[:4]}")


def test_remat_changes_no_gradient():
    """``remat="full"`` recomputes each encoder and decoder layer in the
    backward (the first of each runs twice) and changes no bit."""
    _, _, full = _pair("bf16", remat="full")
    _, _, none = _pair("bf16", remat="none")
    batch = _batch(full.cfg, 5)
    calls = {}
    for key, model in (("full", full), ("none", none)):
        for side in ("enc_layers", "dec_layers"):
            layer = getattr(model, side)[0]

            def counted(*a, key=key, side=side, forward=layer.forward):
                calls[key, side] = calls.get((key, side), 0) + 1
                return forward(*a)
            layer.forward = counted
    loss_full, g_full = _port_grads(full, batch)
    loss_none, g_none = _port_grads(none, batch)
    assert calls == {("full", "enc_layers"): 2, ("full", "dec_layers"): 2,
                     ("none", "enc_layers"): 1, ("none", "dec_layers"): 1}
    assert loss_full == loss_none
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(g_full)[0],
                                 jax.tree_util.tree_flatten_with_path(g_none)[0]):
        assert torch.equal(a, b), jax.tree_util.keystr(path)


# --------------------------------------------------------------------- #
# tests/test_arch_smoke.py's four checks, on the port
# --------------------------------------------------------------------- #
SMOKE_TRAIN = ShapeSpec("smoke_train", seq_len=32, global_batch=2, kind="train")
SMOKE_DECODE = ShapeSpec("smoke_decode", seq_len=32, global_batch=2, kind="decode")


@pytest.fixture(scope="module")
def arch():
    cfg = registry.get_smoke_config(NAME)
    return cfg, build_model(cfg, device="cpu")


def test_arch_forward_loss(arch):
    cfg, model = arch
    batch = make_batch(cfg, SMOKE_TRAIN, device="cpu")
    assert batch["frames"].shape == (2, 32, cfg.frontend_dim) and batch["tokens"].shape == (2, 4)
    with torch.no_grad():
        loss, _ = model.loss(batch)
    assert loss.shape == () and torch.isfinite(loss) and float(loss) > 0


def test_arch_train_step_reduces_loss(arch):
    """A few SGD steps on fp32 master weights strictly reduce the loss."""
    cfg, _ = arch
    batch = make_batch(cfg, SMOKE_TRAIN, device="cpu")
    model = EncDecModel(cfg, device="cpu")
    params = dict(model.named_parameters())
    dtypes = {n: p.dtype for n, p in params.items()}
    p32 = {n: p.detach().float() for n, p in params.items()}

    def step(p32):
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(p32[n].to(dtypes[n]))
        for p in params.values():
            p.requires_grad_(True)
        loss, _ = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return float(loss.detach()), {n: p32[n] - 0.3 * g.float() for n, g in zip(params, grads)}

    l0, p32 = step(p32)
    for _ in range(2):
        l2, p32 = step(p32)
    assert np.isfinite(l0) and np.isfinite(l2) and l2 < l0, (l0, l2)


def test_arch_decode_step(arch):
    cfg, model = arch
    b = SMOKE_DECODE.global_batch
    cache = model.init_cache(b, SMOKE_DECODE.seq_len)
    batch = make_batch(cfg, SMOKE_DECODE, device="cpu")
    with torch.no_grad():
        logits, new_cache = model.decode_step(cache, batch)
    assert logits.shape == (b, 1, cfg.vocab) and torch.isfinite(logits.float()).all()
    assert {k: (v.shape, v.dtype) for k, v in new_cache.items()} == {
        k: (v.shape, v.dtype) for k, v in cache.items()}


def test_arch_prefill_then_decode_consistency(arch):
    """Prefill's logits, then 16 tokens decoded one by one from its cache,
    match the teacher-forced forward of token 0 and those tokens over the
    same frames."""
    cfg, model = arch
    batch = make_batch(cfg, ShapeSpec("t", seq_len=16, global_batch=2, kind="prefill"),
                       device="cpu")
    toks = _t(_tokens(cfg, 6, s=16)).long()
    with torch.no_grad():
        logits, cache = model.prefill(batch)
        rows = [logits]
        for t in range(16):
            logits, cache = model.decode_step(
                cache, {"tokens": toks[:, t:t + 1], "pos": torch.tensor(t + 1)})
            rows.append(logits)
        want = model(torch.cat([torch.zeros((2, 1), dtype=torch.int64), toks], 1),
                     batch["frames"])
    np.testing.assert_allclose(_np(torch.cat(rows, 1)), _np(want), rtol=0.15, atol=0.15)


# --------------------------------------------------------------------- #
# trees across packages
# --------------------------------------------------------------------- #
def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_cache_tree_crosses_packages_bitwise():
    """``cache_from_jax``/``cache_to_tree``: the reference's ``init_cache``
    and a prefill's cache carried into the port and back, every leaf bit for
    bit, in the reference's nested layout (``self`` and ``cross``, each a
    dict of ``k`` and ``v``)."""
    jcfg, params, model = _pair("bf16")
    jm = jax_build_model(jcfg)
    for tree in (jm.init_cache(3, 8),
                 jax.jit(jm.prefill)(params, {"frames": _frames(jcfg, 7, s=16)})[1]):
        cache = cache_from_jax(model, jax.tree.map(np.asarray, tree))
        b, s = cache["cross_k"].shape[1:3]
        shapes = model.cache_shape(b, s)
        assert {k: (v.shape, v.dtype) for k, v in cache.items()} == {
            k: (v.shape, v.dtype) for k, v in shapes.items()}
        back = cache_to_tree(model, cache)
        assert (jax.tree.structure(jax.tree.map(lambda _: 0, back))
                == jax.tree.structure(jax.tree.map(lambda _: 0, tree)))
        for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            want = np.asarray(want)
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            assert torch.equal(_bits(got), _bits(_t(want)))
    fresh = model.init_cache(3, 8)
    ref = cache_from_jax(model, jax.tree.map(np.asarray, jm.init_cache(3, 8)))
    assert all(torch.equal(fresh[k], ref[k]) for k in fresh)


def test_param_tree_layout_is_the_references():
    """Every leaf of the reference's ``init`` maps onto a parameter (names
    ``enc_layers.<l>.attn.<leaf>``, ``enc_layers.<l>.mlp.<leaf>``,
    ``dec_layers.<l>.xattn.<leaf>``, ``dec_layers.<l>.ln3``, ``enc_norm``,
    ``frontend_proj`` …) and back bit for bit, in the reference's dtypes;
    the port's own draw has the reference's leaves, shapes and dtypes."""
    jcfg, params, model = _pair("bf16")
    names = dict(model.named_parameters())
    assert "enc_layers.1.attn.bq" in names and "dec_layers.1.xattn.bo" in names
    assert "dec_layers.0.ln3" in names and "enc_layers.0.mlp.b1" in names
    assert "enc_norm" in names and "frontend_proj" in names
    back = jax.tree_util.tree_flatten_with_path(to_tree(names))[0]
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [jax.tree_util.keystr(p) for p, _ in back] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, got), (_, w) in zip(back, want):
        w = np.asarray(w)
        assert tuple(got.shape) == w.shape, jax.tree_util.keystr(path)
        assert torch.equal(_bits(got), _bits(_t(w))), jax.tree_util.keystr(path)
    drawn = to_tree(dict(build_model(registry.get_smoke_config(NAME), device="cpu")
                         .named_parameters()))
    for (path, got), (_, w) in zip(jax.tree_util.tree_flatten_with_path(drawn)[0], want):
        assert (tuple(got.shape), got.dtype) == (w.shape, _t(w).dtype), \
            jax.tree_util.keystr(path)
