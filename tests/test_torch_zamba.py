"""The port's ``hybrid`` family, Zamba2 (``repro_torch.models.ssd``'s SSD
core, the ``Mamba2`` block of ``models/blocks.py``, ``ZambaModel`` of
``models/recurrent.py``) against the JAX package on the same seeded inputs
and, for the block and the model, the reference's ``init`` carried across.
Tolerances:

- The SSD core in fp32: the chunked form within 1e-5 of the reference's
  and of the port's own step-by-step chain (measured ≤ 3.1e-6); one decode
  step within 1e-5 of the reference's and of a chunked call at S = 1; two
  calls with the state carried within 1e-5 of one long call.
- The SSD backward: where the reference's is finite, every gradient within
  1e-5 of the largest |g|.  From S = 128 in one chunk of 256 with a log
  decay of -0.7 a token (about Mamba2's at init), the reference's ∂la is not
  finite (``ssd.py``'s masked ``exp(L_j - L_s)`` overflows and its backward
  multiplies the infinity by a zero gradient); the port's forward is the
  reference's within 1e-5 of its largest |y|, its gradients are finite,
  equal to the reference's wherever those are and, ∂la too, within 1e-4 of
  the gradients through its own chain of decode steps.
- The Mamba2 block on the same input: fp32 within 1e-5 of the output's
  largest |y| (measured ≤ 1.1e-6); bf16 within 2^-5 of it (measured ≤
  0.0125: the packages round the bf16 elementwise chains in different
  places, XLA a fused chain once, torch every op's output), states
  likewise.
- The smoke model in fp32 (every leaf upcast; the caches stay bf16 but the
  SSM state): ``loss`` and the forward within 1e-5 and 1e-4 (measured 0
  and 3.0e-6).  Decoding is held step by step from the reference's own
  cache (the port's step on the reference's cache): logits within 1e-4
  (measured ≤ 1.4e-6), the fp32 SSM state within 1e-4, the bf16 leaves
  within one bf16 ULP of their value (an fp32 input a hair from a rounding
  boundary rounds the other way in one package).  The port's own chain of
  20 steps is held within 1e-4 until such a flip and within
  ``FLIPPED_TOL`` after it (measured 6.0e-4: one flipped k, v or tail
  element moves the later logits).
- The smoke model in bf16 (as configured): ``loss`` within 0.02, logits
  within 0.25 and every cache leaf within 2^-4 of its largest |x| (the
  recurrent states carry every step's rounding on, as xLSTM's; measured:
  logits ≤ 0.074, 0.055 over the 20-step chain, where the reference's own
  bf16 logits lie 0.034 from its fp32 ones; the cache ≤ 0.03 of its
  scale).
- Gradients against ``jax.value_and_grad``: fp32 within 1e-4 of the leaf's
  largest |g| (measured ≤ 1.7e-6), the shared block's equal to the sum of
  its gradients at each macro's application; bf16 against the reference's
  fp32 gradients within 0.05 plus twice the reference's own bf16 gap on
  that leaf (measured: the port ≤ 0.024, the reference ≤ 0.035).
  ``remat`` on and off: bit for bit.
- ``tests/test_arch_smoke.py``'s four checks for the zamba2 smoke config,
  on the port's model, with the reference's tolerance for prefill against
  the decode chain (0.15).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import ssd as jssd
from repro.models import transformer as jtransformer
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import registry
from repro_torch.launch.specs import make_batch
from repro_torch.models import ssd
from repro_torch.models.api import build_model
from repro_torch.models.blocks import Mamba2
from repro_torch.models.common import ShapeSpec
from repro_torch.models.convert import (cache_from_jax, cache_to_tree, lm_params_from_jax,
                                        tensor_from_numpy, to_tree)
from repro_torch.models.recurrent import ZambaModel

torch.set_num_threads(1)

NAME = "zamba2_7b"
BLOCK_TOL = {"fp32": 1e-5, "bf16": 2.0 ** -5}  # relative to the output's largest |y|
LOGIT_TOL = {"fp32": 1e-4, "bf16": 0.25}
STATE_TOL = {"fp32": 1e-4, "bf16": 2.0 ** -4}  # bf16: relative to the leaf's largest |x|
LOSS_TOL = {"fp32": 1e-5, "bf16": 0.02}
FLIPPED_TOL = 2e-2
# the flat cache's keys in the order of the reference's nested tree's leaves
CACHE_KEYS = ("attn_k", "attn_v", "mamba_conv_x", "mamba_conv_bc", "mamba_ssm")


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


def _ssd_inputs(seed, b=2, s=16, h=2, n=4, p=4, la=None):
    """``tests/test_ssd.py``'s SSD inputs; ``la`` a constant log decay."""
    rng = np.random.default_rng(seed)
    lad = -np.abs(rng.normal(0.3, 0.3, (b, s, h))).astype(np.float32)
    if la is not None:
        lad = np.full((b, s, h), la, np.float32)
    q = rng.normal(0, 1, (b, s, n)).astype(np.float32)
    k = rng.normal(0, 1, (b, s, n)).astype(np.float32)
    v = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    return lad, q, k, v


# --------------------------------------------------------------------- #
# the SSD core
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("chunk", [2, 4, 8, 16])
def test_ssd_chunked_matches_the_reference_and_the_decode_chain(chunk, seed):
    arrs = _ssd_inputs(seed)
    y, st = ssd.ssd_chunked(*map(torch.from_numpy, arrs), chunk=chunk)
    jy, jst = jssd.ssd_chunked(*map(jnp.asarray, arrs), chunk=chunk)
    _close(y, jy, 1e-5, "y")
    _close(st, jst, 1e-5, "state")
    la, q, k, v = arrs
    b, s, h = la.shape
    state = torch.zeros((b, h, q.shape[-1], v.shape[-1]))
    ys = []
    for t in range(s):
        y_t, state = ssd.ssd_decode_step(*(torch.from_numpy(a[:, t]) for a in arrs), state)
        ys.append(y_t)
    _close(y, torch.stack(ys, 1), 1e-5, "chunked vs the decode chain")
    _close(st, state, 1e-5, "final state vs the decode chain")


def test_ssd_decode_step_matches_the_reference_and_the_chunked_tail():
    """``tests/test_ssd.py``'s ``test_ssd_decode_matches_chunked_tail`` on
    the port, and the step against the reference's."""
    la, q, k, v = _ssd_inputs(3, s=1)
    s0 = np.random.default_rng(4).normal(0, 1, (2, 2, 4, 4)).astype(np.float32)
    y_c, s_c = ssd.ssd_chunked(*map(torch.from_numpy, (la, q, k, v)), s0=torch.from_numpy(s0),
                               chunk=1)
    step = (la[:, 0], q[:, 0], k[:, 0], v[:, 0])
    y_d, s_d = ssd.ssd_decode_step(*map(torch.from_numpy, step), torch.from_numpy(s0))
    jy, js = jssd.ssd_decode_step(*map(jnp.asarray, step), jnp.asarray(s0))
    _close(y_c[:, 0], y_d, 1e-5, "chunked tail y")
    _close(s_c, s_d, 1e-5, "chunked tail state")
    _close(y_d, jy, 1e-5, "y vs the reference")
    _close(s_d, js, 1e-5, "state vs the reference")


def test_ssd_state_carry_across_calls():
    """Two chunked calls with the state carried == one long call, in the
    port, and the second call equal to the reference's from the same
    state."""
    arrs = _ssd_inputs(1, b=1, s=32)
    full, st_full = ssd.ssd_chunked(*map(torch.from_numpy, arrs), chunk=8)
    first = [torch.from_numpy(a[:, :16]) for a in arrs]
    second = [a[:, 16:] for a in arrs]
    y1, st1 = ssd.ssd_chunked(*first, chunk=8)
    y2, st2 = ssd.ssd_chunked(*map(torch.from_numpy, second), s0=st1, chunk=8)
    _close(torch.cat([y1, y2], 1), full, 1e-5, "y")
    _close(st2, st_full, 1e-5, "state")
    jy2, jst2 = jssd.ssd_chunked(*map(jnp.asarray, second), s0=jnp.asarray(st1.numpy()), chunk=8)
    _close(y2, jy2, 1e-5, "y vs the reference")
    _close(st2, jst2, 1e-5, "state vs the reference")


def _core_grads(arrs, chunk=None):
    """The port's gradients of y and the final state summed: through the
    chunked core, or (``chunk`` None) through a chain of decode steps."""
    args = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    if chunk is not None:
        y, st = ssd.ssd_chunked(*args, chunk=chunk)
    else:
        la, q, k, v = args
        st = torch.zeros((la.shape[0], la.shape[2], q.shape[-1], v.shape[-1]))
        ys = []
        for t in range(la.shape[1]):
            y_t, st = ssd.ssd_decode_step(la[:, t], q[:, t], k[:, t], v[:, t], st)
            ys.append(y_t)
        y = torch.stack(ys, 1)
    return y, torch.autograd.grad(y.sum() + st.sum(), args)


def _ref_core_grads(arrs, chunk):
    def f(*a):
        y, st = jssd.ssd_chunked(*a, chunk=chunk)
        return y.sum() + st.sum()
    return jax.grad(f, argnums=(0, 1, 2, 3))(*map(jnp.asarray, arrs))


@pytest.mark.parametrize("s, la, ref_finite", [(16, None, True), (64, -0.7, True),
                                                (128, -0.7, False), (256, -0.7, False)])
def test_ssd_backward_matches_the_reference_and_stays_finite(s, la, ref_finite):
    """``jax.grad`` of the reference's core (y and the final state summed)
    against the port's autograd, one chunk of 256: equal within 1e-5 of the
    largest |g| wherever the reference's is finite.  From S = 128 at a log
    decay of -0.7 a token the chunk's cumulative decay passes -88.7 and the
    reference's ∂la is not finite anywhere; the port's is, and equals the
    gradient through the port's chain of decode steps (which multiplies one
    token's decay at a time and cannot overflow) within 1e-4 of its largest
    |g|; the forward is the reference's either way."""
    arrs = _ssd_inputs(5, b=1, s=s, la=la)
    y, got = _core_grads(arrs, 256)
    jy, _ = jssd.ssd_chunked(*map(jnp.asarray, arrs), chunk=256)
    _close(y, jy, 1e-5 * np.abs(np.asarray(jy)).max(), "y")
    want = _ref_core_grads(arrs, 256)
    assert np.isfinite(np.asarray(want[0])).all() == ref_finite
    assert all(np.isfinite(np.asarray(w)).all() for w in want[1:])  # ∂q, ∂k, ∂v
    assert all(bool(torch.isfinite(g).all()) for g in got)
    for g, w in zip(got, want):  # equal wherever the reference's is finite
        w = np.asarray(w)
        keep = np.isfinite(w)
        assert np.abs(_np(g)[keep] - w[keep]).max(initial=0) <= 1e-5 * np.abs(w[keep]).max(
            initial=0)
    _, chain = _core_grads(arrs)
    for g, w in zip(got, chain):
        _close(g, w, 1e-4 * float(w.abs().max()), "vs the decode chain's gradient")


# --------------------------------------------------------------------- #
# the Mamba2 block on the same input
# --------------------------------------------------------------------- #
def _cast(tree, prec):
    return jax.tree.map(lambda a: a.astype(jnp.float32), tree) if prec == "fp32" else tree


def _input(rng, shape, prec, scale=1.0):
    x = (rng.normal(0, 1, shape) * scale).astype(np.float32)
    if prec == "bf16":
        return jnp.asarray(x, jnp.bfloat16)
    return jnp.asarray(x)


def _rel_close(got, want, prec, what):
    scale = float(np.abs(_np(want)).max()) or 1.0
    rel = _gap(got, want) / scale
    assert rel <= BLOCK_TOL[prec], f"{what}: {rel} of its scale > {BLOCK_TOL[prec]}"
    return rel


def _load(module, tree):
    for leaf, arr in tree.items():
        getattr(module, leaf).data = _t(arr).clone()
    return module


def _mamba_state(rng, b, cfg):
    ssm = cfg.ssm
    d_in = ssm.expand * cfg.d_model
    cw = ssm.conv_width
    return (jnp.asarray(rng.normal(0, 1, (b, cw - 1, d_in)), jnp.bfloat16),
            jnp.asarray(rng.normal(0, 1, (b, cw - 1, 2 * ssm.d_state)), jnp.bfloat16),
            jnp.asarray(rng.normal(0, 0.3, (b, d_in // ssm.head_dim, ssm.d_state,
                                            ssm.head_dim)).astype(np.float32)))


def _torch_state(state):
    return tuple(_t(a) for a in state)


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_mamba_block(prec):
    """``Mamba2`` against ``mamba_apply`` from fresh and from a carried
    state (S = 32, two chunks of 16), and ``Mamba2.decode`` against
    ``mamba_decode``; the leaves' names, shapes and dtypes are
    ``mamba_init``'s."""
    cfg, jcfg = registry.get_smoke_config(NAME), jreg.get_smoke_config(NAME)
    p = _cast(jblocks.mamba_init(jax.random.PRNGKey(3), jcfg), prec)
    fresh = Mamba2(cfg, torch.Generator().manual_seed(0))
    assert {n: (tuple(q.shape), q.dtype) for n, q in fresh.named_parameters()} == {
        n: (a.shape, _t(a).dtype) for n, a in jblocks.mamba_init(jax.random.PRNGKey(3),
                                                                 jcfg).items()}
    block = _load(fresh, p)
    rng = np.random.default_rng(7)
    u = _input(rng, (2, 32, cfg.d_model), prec)
    state = _mamba_state(rng, 2, cfg)
    worst = 0.0
    for st in (None, state):
        y, new = block(_t(u), None if st is None else _torch_state(st))
        jy, jnew = jblocks.mamba_apply(p, u, jcfg, state=st)
        worst = max(worst, _rel_close(y, jy, prec, "y"))
        assert y.dtype == _t(jy).dtype and [a.dtype for a in new] == [_t(a).dtype for a in jnew]
        for got, want, what in zip(new, jnew, ("x tail", "bc tail", "ssm")):
            worst = max(worst, _rel_close(got, want, prec, what))
    u1 = _input(rng, (2, 1, cfg.d_model), prec)
    y, new = block.decode(_t(u1), _torch_state(state))
    jy, jnew = jblocks.mamba_decode(p, u1, jcfg, state)
    worst = max(worst, _rel_close(y, jy, prec, "decode y"))
    for got, want, what in zip(new, jnew, ("x tail", "bc tail", "ssm")):
        assert got.dtype == _t(want).dtype
        worst = max(worst, _rel_close(got, want, prec, f"decode {what}"))
    print(f"{prec}: worst {worst}")


# --------------------------------------------------------------------- #
# the smoke model on the reference's init
# --------------------------------------------------------------------- #
def _pair(prec, **over):
    jcfg = dataclasses.replace(jreg.get_smoke_config(NAME), **over)
    params = _cast(jax_build_model(jcfg).init(jax.random.PRNGKey(0)), prec)
    cfg = dataclasses.replace(registry.get_smoke_config(NAME), **over)
    model = lm_params_from_jax(build_model(cfg, device="cpu"), jax.tree.map(np.asarray, params))
    return jcfg, params, model


def _tokens(cfg, seed, b=2, s=32):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _cache_close(got, want, prec, tol=None):
    """The port's flat cache against the reference's nested tree: in fp32
    the bf16 leaves within one bf16 ULP of their value; returns the worst
    gap of the others."""
    worst = 0.0
    assert len(jax.tree.leaves(want)) == len(CACHE_KEYS)
    for key, w in zip(CACHE_KEYS, jax.tree.leaves(want)):
        g = got[key]
        assert g.dtype == _t(w).dtype, key
        if g.dtype == torch.bfloat16 and prec == "fp32":
            np.testing.assert_allclose(_np(g), _np(w), rtol=2.0 ** -7, atol=1e-6, err_msg=key)
        elif prec == "fp32":
            worst = max(worst, _close(g, w, tol or STATE_TOL[prec], key))
        else:
            scale = float(np.abs(_np(w)).max()) or 1.0
            worst = max(worst, _close(g, w, STATE_TOL[prec] * scale, key) / scale)
    return worst


def _flipped(cache, jcache):
    """Whether a bf16 leaf of the port's cache differs from the
    reference's."""
    return any(cache[key].dtype == torch.bfloat16 and not np.array_equal(_np(cache[key]), _np(w))
               for key, w in zip(CACHE_KEYS, jax.tree.leaves(jcache)))


def _pos(t):
    """Decode step ``t``'s position: a scalar on even steps, a per-slot
    vector on odd ones (slot 1 lagging, rewriting its earlier rows); from
    step 16 past the 24-row cache's end for slot 0, whose writes are
    dropped."""
    return np.int32(8 + t) if t % 2 == 0 else np.array([8 + t, 4 + t // 2], np.int32)


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_model_against_the_reference(prec):
    """``loss``, the forward and ``prefill`` of the smoke model, then 20
    ``decode_step``s on a 24-row cache with scalar and per-slot ``pos``
    (past the cache's end for one slot): each step on the reference's own
    cache, and the port's chain."""
    jcfg, params, model = _pair(prec)
    jm = jax_build_model(jcfg)
    assert isinstance(model, ZambaModel) and (model.n_macro, model.m_per_macro) == (2, 2)
    toks = _tokens(jcfg, 1)
    labels = np.roll(toks, -1, axis=1)
    jloss, _ = jax.jit(jm.loss)(params, {"tokens": jnp.asarray(toks),
                                         "labels": jnp.asarray(labels)})
    with torch.no_grad():
        loss, metrics = model.loss({"tokens": _t(toks), "labels": _t(labels)})
        logits = model(_t(toks))
    assert set(metrics) == {"xent"}
    gaps = {"loss": _close(loss, jloss, LOSS_TOL[prec], "loss")}
    jfull = jax.jit(lambda p, x: jtransformer._logits(
        p, jcommon.rms_norm(jm._run(p, p["embed"][x], jnp.broadcast_to(
            jnp.arange(x.shape[1], dtype=jnp.int32), x.shape))[0], p["final_norm"],
            jcfg.norm_eps), jcfg))(params, jnp.asarray(toks))
    gaps["forward"] = _close(logits, jfull, LOGIT_TOL[prec], "forward logits")
    # prefill: the cache's k and v hold the prompt's 8 positions
    jlog, jpre = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks[:, :8])})
    with torch.no_grad():
        plog, pre = model.prefill({"tokens": _t(toks[:, :8])})
        head = model(_t(toks[:, :8]))
    assert plog.shape == (2, 1, jcfg.vocab) and pre["attn_k"].shape[2] == 8
    gaps["prefill"] = _close(plog, jlog, LOGIT_TOL[prec], "prefill logits")
    _close(head[:, -1:], plog, LOGIT_TOL[prec] / 10, "the forward's last logits vs prefill")
    gaps["prefill cache"] = _cache_close(pre, jpre, prec)
    # decode from the prefill's states, on a 24-row KV cache holding its k, v
    jcache = jm.init_cache(2, 24)
    jcache = {"mamba": jpre["mamba"], "attn_kv": {
        key: jcache["attn_kv"][key].at[:, :, :8].set(jpre["attn_kv"][key])
        for key in ("k", "v")}}
    cache = cache_from_jax(model, jax.tree.map(np.asarray, jcache))
    dec = jax.jit(jm.decode_step)
    step_gap, chain_gap, flipped = 0.0, 0.0, False
    for t in range(20):
        tok = toks[:, 8 + t % 24:9 + t % 24]
        batch = {"tokens": _t(tok).long(), "pos": torch.as_tensor(_pos(t)).long()}
        own = cache_from_jax(model, jax.tree.map(np.asarray, jcache))
        jlog, jcache = dec(params, jcache, {"tokens": jnp.asarray(tok),
                                            "pos": jnp.asarray(_pos(t))})
        before = {k: v.clone() for k, v in cache.items()}
        with torch.no_grad():
            slog, snew = model.decode_step(own, batch)
            dlog, cache_new = model.decode_step(cache, batch)
        assert all(torch.equal(before[k], cache[k]) for k in cache)  # the input is not written
        cache = cache_new
        step_gap = max(step_gap, _close(slog, jlog, LOGIT_TOL[prec], f"step {t}"))
        _cache_close(snew, jcache, prec)
        tol = FLIPPED_TOL if flipped and prec == "fp32" else LOGIT_TOL[prec]
        chain_gap = max(chain_gap, _close(dlog, jlog, tol, f"chain step {t}"))
        _cache_close(cache, jcache, prec, FLIPPED_TOL if flipped and prec == "fp32" else None)
        flipped = flipped or _flipped(cache, jcache)
    gaps.update(step=step_gap, chain=chain_gap, flipped=flipped)
    print(f"{prec}: {gaps}; logits max |x| {float(logits.abs().max()):.3f}")


def test_cache_shape_is_the_references():
    jcfg, _, model = _pair("bf16")
    want = jax_build_model(jcfg).cache_shape(3, 24)
    shapes = model.cache_shape(3, 24)
    assert cache_to_tree(model, shapes).keys() == want.keys()
    for key, w in zip(CACHE_KEYS, jax.tree.leaves(want)):
        assert tuple(shapes[key].shape) == w.shape, key
        assert str(shapes[key].dtype).split(".")[-1] == str(w.dtype), key


def _port_grads(model, toks, labels):
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss, _ = model.loss({"tokens": _t(toks), "labels": _t(labels)})
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


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_gradients_equal_the_reference(prec):
    """fp32: every leaf within 1e-4 of its largest |g| of the reference's.
    bf16: each port leaf held to the reference's fp32 gradient within 0.05
    plus twice the reference's own bf16 gap on that leaf (its bf16
    rounding carried through the recurrent states)."""
    jcfg, params, model = _pair(prec)
    toks = _tokens(jcfg, 2)
    labels = np.roll(toks, -1, axis=1)
    jm = jax_build_model(jcfg)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    grad_fn = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))
    (want_loss, _), want = grad_fn(params, batch)
    loss, got = _port_grads(model, toks, labels)
    assert abs(loss - float(want_loss)) <= LOSS_TOL[prec]
    worst = {}
    if prec == "fp32":
        for path, g, w in _grad_leaves(got, want):
            assert g.shape == w.shape, path
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err <= 1e-4, (path, err)
            worst[path] = float(err)
    else:
        _, want32 = grad_fn(_cast(params, "fp32"), batch)
        for (path, g, w32), (_, w, _) in zip(_grad_leaves(got, want32),
                                             _grad_leaves(want, want32)):
            port, ref = _rel(g, w32), _rel(w, w32)
            assert port <= 0.05 + 2 * ref, (path, port, ref)
            worst[path] = (round(port, 4), round(ref, 4), round(_rel(g, w), 4))
    print(f"{prec}: {sorted(worst.items(), key=lambda kv: kv[1], reverse=True)[:4]}")


def test_shared_block_gradient_sums_its_applications():
    """The one shared block serves every macro: its gradient is the sum of
    the gradients of per-macro copies of it (the same values), which the
    reference's ``jax.grad`` gives too (fp32, within 1e-4 of the largest
    |g|)."""
    jcfg, params, model = _pair("fp32")
    toks = _tokens(jcfg, 2)
    labels = np.roll(toks, -1, axis=1)
    _, got = _port_grads(model, toks, labels)
    copies = [copy.deepcopy(model.shared) for _ in range(model.n_macro)]
    run = model._macro

    def per_copy(i, h, positions, states):
        h, new = model.macros[i](h, states)
        h, kv, _ = copies[i](h, positions)
        return h, new, kv

    model._macro = per_copy
    for p in model.shared.parameters():
        p.requires_grad_(False)
    leaves = [dict(c.named_parameters()) for c in copies]
    for c in leaves:
        for p in c.values():
            p.requires_grad_(True)
    loss, _ = model.loss({"tokens": _t(toks), "labels": _t(labels)})
    grads = torch.autograd.grad(loss, [p for c in leaves for p in c.values()])
    model._macro = run
    names = list(leaves[0])
    parts = [dict(zip(names, grads[i * len(names):(i + 1) * len(names)]))
             for i in range(model.n_macro)]
    jgrad = jax.jit(jax.grad(lambda p: jax_build_model(jcfg).loss(
        p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})[0]))(params)
    for name in names:
        total = sum(part[name] for part in parts)
        node, want = got["shared"], jgrad["shared"]
        for key in name.split("."):
            node, want = node[key], want[key]
        scale = float(np.abs(np.asarray(want)).max())
        assert _gap(total, node) <= 1e-5 * scale, name
        assert _gap(node, want) <= 1e-4 * scale, name
        assert min(_gap(part[name], node) for part in parts) > 1e-3 * scale, name


def test_remat_changes_no_gradient():
    _, _, full = _pair("bf16", remat="full")
    _, _, none = _pair("bf16", remat="none")
    toks = _tokens(full.cfg, 3)
    labels = np.roll(toks, -1, axis=1)
    calls = {"full": 0, "none": 0}
    for key, model in (("full", full), ("none", none)):
        def counted(*a, key=key, forward=model.macros[0].forward):
            calls[key] += 1
            return forward(*a)
        model.macros[0].forward = counted
    loss_full, g_full = _port_grads(full, toks, labels)
    loss_none, g_none = _port_grads(none, toks, labels)
    assert calls == {"full": 2, "none": 1}  # the backward ran macro 0 again
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
    with torch.no_grad():
        loss, _ = model.loss(batch)
    assert loss.shape == () and torch.isfinite(loss) and float(loss) > 0


def test_arch_train_step_reduces_loss(arch):
    """A few SGD steps on fp32 master weights strictly reduce the loss."""
    cfg, _ = arch
    batch = make_batch(cfg, SMOKE_TRAIN, device="cpu")
    model = ZambaModel(cfg, device="cpu")
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
    """Prefill's last logits match the same tokens decoded one by one, and
    its states and k, v the chain's."""
    cfg, model = arch
    batch = make_batch(cfg, ShapeSpec("t", seq_len=16, global_batch=2, kind="prefill"),
                       device="cpu")
    with torch.no_grad():
        logits_p, cache_p = model.prefill(batch)
        cache = model.init_cache(2, 16)
        for t in range(16):
            logits_d, cache = model.decode_step(
                cache, {"tokens": batch["tokens"][:, t:t + 1], "pos": torch.tensor(t)})
    np.testing.assert_allclose(_np(logits_p), _np(logits_d), rtol=0.15, atol=0.15)
    for key in cache:
        np.testing.assert_allclose(_np(cache_p[key]), _np(cache[key]), rtol=0.15, atol=0.15)


# --------------------------------------------------------------------- #
# trees across packages
# --------------------------------------------------------------------- #
def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_cache_tree_crosses_packages_bitwise():
    """``cache_from_jax``/``cache_to_tree``: the reference's ``init_cache``
    and a prefill's cache carried into the port and back, every leaf bit for
    bit, in the reference's nested layout (``attn_kv`` a dict)."""
    jcfg, params, model = _pair("bf16")
    jm = jax_build_model(jcfg)
    for tree in (jm.init_cache(3, 8),
                 jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(_tokens(jcfg, 4, s=8))})[1]):
        cache = cache_from_jax(model, jax.tree.map(np.asarray, tree))
        b = cache["mamba_ssm"].shape[2]
        shapes = model.cache_shape(b, cache["attn_k"].shape[2])
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
    ``macros.<i>.mamba.<j>.<leaf>``, ``macros.<i>.mamba_ln.<j>``,
    ``shared.ln1``, ``shared.attn.<leaf>``, ``shared.mlp.<leaf>``) and back
    bit for bit, in the reference's dtypes; the shared block's leaves carry
    no stacked axis."""
    jcfg, params, model = _pair("bf16")
    names = dict(model.named_parameters())
    assert "macros.1.mamba.1.wz" in names and "macros.1.mamba_ln.1" in names
    assert "shared.attn.wq" in names and "shared.mlp.w2" in names and "shared.ln2" in names
    assert not any(n.startswith("macros.") and ".attn." in n for n in names)
    for leaf in ("a_log", "d_skip", "dt_bias"):
        assert names[f"macros.0.mamba.0.{leaf}"].dtype == torch.float32, leaf
    back = jax.tree_util.tree_flatten_with_path(to_tree(names))[0]
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [jax.tree_util.keystr(p) for p, _ in back] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, got), (_, w) in zip(back, want):
        w = np.asarray(w)
        assert tuple(got.shape) == w.shape, jax.tree_util.keystr(path)
        assert torch.equal(_bits(got), _bits(_t(w))), jax.tree_util.keystr(path)
    assert tuple(to_tree(names)["shared"]["attn"]["wq"].shape) == tuple(
        params["shared"]["attn"]["wq"].shape)
