"""The port's ``ssm`` family, xLSTM (``repro_torch.models.ssd``, the mLSTM
and sLSTM blocks of ``models/blocks.py``, ``models/recurrent.py``) against
the JAX package on the same seeded inputs and, for the blocks and the
model, the reference's ``init`` carried across.  Tolerances:

- The mLSTM core in fp32: the chunked form within 1e-5 of the reference's
  (measured ≤ 2.3e-6) and within 3e-3 of the port's own step-by-step
  chain (``tests/test_ssd.py``'s bound between the reference's two; measured
  ≤ 1.5e-6); one decode step within 1e-5; two calls with the state carried
  within 1e-5 of one long call.
- Blocks on the same input: fp32 within 1e-5 of the output's largest |y|
  (measured ≤ 5.2e-7); bf16 within 2^-5 of it (measured ≤ 2^-6, the causal
  conv's four rounded taps: the packages round the bf16 elementwise chains
  in different places, XLA a fused chain once, torch every op's output),
  states within 2^-5 of their largest |x| too (measured ≤ 8.3e-3).
- The smoke model in fp32 (every leaf upcast): ``loss`` within 1e-5,
  logits of the forward, ``prefill`` and 20 ``decode_step``s within 1e-4
  (measured ≤ 4.0e-6); the fp32 states within 1e-4 (measured ≤ 1.2e-5), the
  mLSTM's bf16 conv tail within one bf16 ULP of its value (an fp32 input
  a hair from a rounding boundary rounds the other way in one package).
- The smoke model in bf16 (as configured): ``loss`` within 0.02 (measured
  0.0015), logits within 0.25 (measured 0.109 over 20 decode steps, 0.078
  over the forward, 0.047 at prefill: the recurrent states carry every
  step's rounding on, where the dense models' 0.1 holds a KV cache) and
  states within 0.25 (measured ≤ 0.144).
- Gradients against ``jax.value_and_grad``: fp32 within 1e-4 of the
  leaf's largest |g| (``tests/test_torch_grads.py``'s bound; measured
  ≤ 2.9e-6); bf16 against the reference's fp32 gradients, as
  ``test_gradients_equal_the_reference`` says.  ``remat`` on and off: bit
  for bit.
- ``tests/test_arch_smoke.py``'s four checks for the xlstm smoke config,
  on the port's model, with the reference's tolerance for prefill against
  the decode chain (0.15).
"""

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
from repro_torch.models.blocks import MLSTM, SLSTM, _causal_conv
from repro_torch.models.common import ShapeSpec
from repro_torch.models.convert import (cache_from_jax, cache_to_tree, lm_params_from_jax,
                                        tensor_from_numpy, to_tree)
from repro_torch.models.recurrent import XLSTMModel

torch.set_num_threads(1)

NAME = "xlstm_350m"
BLOCK_TOL = {"fp32": 1e-5, "bf16": 2.0 ** -5}  # relative to the output's largest |y|
LOGIT_TOL = {"fp32": 1e-4, "bf16": 0.25}
STATE_TOL = {"fp32": 1e-4, "bf16": 0.25}
LOSS_TOL = {"fp32": 1e-5, "bf16": 0.02}
# the flat cache's keys in the order of the reference's nested tree's leaves
CACHE_KEYS = ("mlstm_conv", "mlstm_s", "mlstm_n", "mlstm_m",
              "slstm_h", "slstm_c", "slstm_n", "slstm_m")


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


def _mlstm_inputs(seed, b=2, s=16, h=2, n=4, p=4):
    """``tests/test_ssd.py``'s mLSTM inputs."""
    rng = np.random.default_rng(seed)
    lf = np.log(1 / (1 + np.exp(-rng.normal(2, 1, (b, s, h))))).astype(np.float32)
    li = rng.normal(-0.5, 1.0, (b, s, h)).astype(np.float32)
    q = rng.normal(0, 1, (b, s, h, n)).astype(np.float32)
    k = rng.normal(0, 1, (b, s, h, n)).astype(np.float32)
    v = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    return lf, li, q, k, v


# --------------------------------------------------------------------- #
# the mLSTM core
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_mlstm_chunked_matches_the_reference_and_the_decode_chain(chunk, seed):
    arrs = _mlstm_inputs(seed)
    y, st = ssd.mlstm_chunked(*map(torch.from_numpy, arrs), chunk=chunk)
    jy, jst = jssd.mlstm_chunked(*map(jnp.asarray, arrs), chunk=chunk)
    _close(y, jy, 1e-5, "y")
    for got, want in zip(st, jst):
        _close(got, want, 1e-5, "state")
    b, s, h = arrs[0].shape
    n, p = arrs[2].shape[-1], arrs[4].shape[-1]
    state = (torch.zeros((b, h, n, p)), torch.zeros((b, h, n)), torch.full((b, h), -1e30))
    ys = []
    for t in range(s):
        y_t, state = ssd.mlstm_decode_step(*(torch.from_numpy(a[:, t]) for a in arrs), state)
        ys.append(y_t)
    _close(y, torch.stack(ys, 1), 3e-3, "chunked vs the decode chain")
    for got, want in zip(st, state):  # the chain's m is the chunked form's
        _close(got, want, 3e-3, "final state vs the decode chain")


def test_mlstm_decode_step_matches_the_reference():
    lf, li, q, k, v = (a[:, 0] for a in _mlstm_inputs(3))
    rng = np.random.default_rng(4)
    b, h, n = q.shape
    state = (rng.normal(0, 1, (b, h, n, v.shape[-1])).astype(np.float32),
             rng.normal(0, 1, (b, h, n)).astype(np.float32),
             rng.normal(0, 1, (b, h)).astype(np.float32))
    y, st = ssd.mlstm_decode_step(*map(torch.from_numpy, (lf, li, q, k, v)),
                                  tuple(map(torch.from_numpy, state)))
    jy, jst = jssd.mlstm_decode_step(*map(jnp.asarray, (lf, li, q, k, v)),
                                     tuple(map(jnp.asarray, state)))
    _close(y, jy, 1e-5, "y")
    for got, want in zip(st, jst):
        _close(got, want, 1e-5, "state")


def test_mlstm_state_carry_across_calls():
    """Two chunked calls with the state carried == one long call, in the
    port, and the second call equal to the reference's from the same
    state."""
    arrs = _mlstm_inputs(5, b=1, s=32)
    full, st_full = ssd.mlstm_chunked(*map(torch.from_numpy, arrs), chunk=8)
    first = [torch.from_numpy(a[:, :16]) for a in arrs]
    second = [a[:, 16:] for a in arrs]
    y1, st1 = ssd.mlstm_chunked(*first, chunk=8)
    y2, st2 = ssd.mlstm_chunked(*map(torch.from_numpy, second), state=st1, chunk=8)
    _close(torch.cat([y1, y2], 1), full, 1e-5, "y")
    for got, want in zip(st2, st_full):
        _close(got, want, 1e-5, "state")
    jy2, jst2 = jssd.mlstm_chunked(*map(jnp.asarray, second),
                                   state=tuple(jnp.asarray(x.numpy()) for x in st1), chunk=8)
    _close(y2, jy2, 1e-5, "y vs the reference")
    for got, want in zip(st2, jst2):
        _close(got, want, 1e-5, "state vs the reference")


def _core_grads(arrs, chunk):
    args = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    y, _ = ssd.mlstm_chunked(*args, chunk=chunk)
    return y, torch.autograd.grad(y.sum(), args)


def _ref_core_grads(arrs, chunk):
    return jax.grad(lambda *a: jssd.mlstm_chunked(*a, chunk=chunk)[0].sum(),
                    argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrs))


def test_mlstm_backward_matches_the_reference_and_stays_finite():
    """The chunked core's gradients (``jax.grad`` of the reference's) within
    1e-5 of the largest |g| on ordinary gates; where an input gate sits 95
    above the others, or every one at -100, the reference's backward
    overflows (a masked exponent past fp32's range, or the normalizer's
    floor ``exp(-m)``, times a zero gradient) and gives non-finite gradients
    of the gates, while the port's forward stays the reference's and its
    gradients finite."""
    arrs = _mlstm_inputs(6)
    _, got = _core_grads(arrs, 8)
    for g, w in zip(got, _ref_core_grads(arrs, 8)):
        assert np.abs(_np(g) - _np(w)).max() <= 1e-5 * np.abs(_np(w)).max()
    lf, li, q, k, v = _mlstm_inputs(7, b=1, s=8, h=1)
    wide = li.copy()
    wide[0, 4, 0] = 95.0
    for gates in (wide, np.full_like(li, -100.0)):
        arrs = (lf, gates, q, k, v)
        y, got = _core_grads(arrs, 8)
        jy, _ = jssd.mlstm_chunked(*map(jnp.asarray, arrs), chunk=8)
        _close(y, jy, 1e-5, "y")
        assert all(bool(torch.isfinite(g).all()) for g in got)
        want = _ref_core_grads(arrs, 8)
        assert not np.isfinite(np.asarray(want[1])).all()  # the reference's li gradient
        for g, w in zip(got, want):  # equal wherever the reference's is finite
            w = np.asarray(w)
            keep = np.isfinite(w)
            assert np.abs(_np(g)[keep] - w[keep]).max(initial=0) <= 1e-4 * max(
                np.abs(w[keep]).max(initial=0), 1.0)


# --------------------------------------------------------------------- #
# blocks on the same input
# --------------------------------------------------------------------- #
def _cfg(prec):
    return registry.get_smoke_config(NAME), jreg.get_smoke_config(NAME)


def _cast(tree, prec):
    return jax.tree.map(lambda a: a.astype(jnp.float32), tree) if prec == "fp32" else tree


def _input(rng, shape, prec):
    x = rng.normal(0, 1, shape).astype(np.float32)
    if prec == "bf16":
        return jnp.asarray(x, jnp.bfloat16)
    return jnp.asarray(x)


def _rel_close(got, want, prec, what):
    scale = float(np.abs(_np(want)).max()) or 1.0
    rel = _gap(got, want) / scale
    assert rel <= BLOCK_TOL[prec], f"{what}: {rel} of its scale > {BLOCK_TOL[prec]}"
    return rel


@pytest.mark.parametrize("hist", [False, True])
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_causal_conv(prec, hist):
    rng = np.random.default_rng(6)
    x, w, b = (_input(rng, s, prec) for s in ((2, 7, 12), (4, 12), (12,)))
    h = _input(rng, (2, 3, 12), prec) if hist else None
    y, tail = _causal_conv(_t(x), _t(w), _t(b), None if h is None else _t(h))
    jy, jtail = jblocks._causal_conv(x, w, b, hist=h)
    assert y.dtype == _t(jy).dtype and tail.dtype == _t(jtail).dtype
    _rel_close(y, jy, prec, "y")
    assert torch.equal(tail, _t(jtail))  # a slice of the inputs
    _, tail0 = _causal_conv(_t(x)[:, :1], _t(w), _t(b))  # a short input's tail is padded
    assert torch.equal(tail0[:, :2], torch.zeros_like(tail0[:, :2]))


def _load(module, tree):
    for leaf, arr in tree.items():
        getattr(module, leaf).data = _t(arr).clone()
    return module


def _mlstm_state(rng, b, cfg, prec):
    d_in = int(cfg.d_model * cfg.xlstm.proj_factor)
    h, cw = cfg.n_heads, cfg.xlstm.conv_width
    hd = d_in // h
    tail = jnp.asarray(rng.normal(0, 1, (b, cw - 1, d_in)), jnp.bfloat16)
    st = rng.normal(0, 0.3, (b, h, hd, hd)).astype(np.float32)
    nt = rng.normal(0, 0.3, (b, h, hd)).astype(np.float32)
    mt = rng.normal(0, 1, (b, h)).astype(np.float32)
    return tail, tuple(map(jnp.asarray, (st, nt, mt)))


def _torch_state(state):
    return jax.tree.map(lambda a: _t(a), state)


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_mlstm_block(prec):
    """``MLSTM`` against ``mlstm_apply`` from fresh and from a carried state
    (S = 16, two chunks of 8), and ``MLSTM.decode`` against
    ``mlstm_decode``."""
    cfg, jcfg = _cfg(prec)
    jcfg = dataclasses.replace(jcfg, xlstm=dataclasses.replace(jcfg.xlstm, chunk=8))
    cfg = dataclasses.replace(cfg, xlstm=dataclasses.replace(cfg.xlstm, chunk=8))
    p = _cast(jblocks.mlstm_init(jax.random.PRNGKey(3), jcfg), prec)
    block = _load(MLSTM(cfg, torch.Generator().manual_seed(0)), p)
    assert {n: q.dtype for n, q in block.named_parameters()} == {
        n: _t(a).dtype for n, a in p.items()}
    rng = np.random.default_rng(7)
    u = _input(rng, (2, 16, cfg.d_model), prec)
    state = _mlstm_state(rng, 2, cfg, prec)
    for st in (None, state):
        y, (tail, mst) = block(_t(u), None if st is None else _torch_state(st))
        jy, (jtail, jmst) = jblocks.mlstm_apply(p, u, jcfg, state=st)
        _rel_close(y, jy, prec, "y")
        _rel_close(tail, jtail, prec, "conv tail")
        for got, want in zip(mst, jmst):
            _rel_close(got, want, prec, "state")
    u1 = _input(rng, (2, 1, cfg.d_model), prec)
    y, (tail, mst) = block.decode(_t(u1), _torch_state(state))
    jy, (jtail, jmst) = jblocks.mlstm_decode(p, u1, jcfg, state)
    _rel_close(y, jy, prec, "decode y")
    _rel_close(tail, jtail, prec, "decode conv tail")
    for got, want in zip(mst, jmst):
        _rel_close(got, want, prec, "decode state")


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_slstm_block(prec):
    """``SLSTM`` against ``slstm_apply`` over 16 steps from fresh and from a
    carried state, and one step (``slstm_decode``)."""
    cfg, jcfg = _cfg(prec)
    p = _cast(jblocks.slstm_init(jax.random.PRNGKey(4), jcfg), prec)
    block = _load(SLSTM(cfg, torch.Generator().manual_seed(0)), p)
    assert {n: q.dtype for n, q in block.named_parameters()} == {
        n: _t(a).dtype for n, a in p.items()}
    rng = np.random.default_rng(8)
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    state = tuple(jnp.asarray(rng.normal(0, 0.5, s).astype(np.float32))
                  for s in ((2, h, hd), (2, h, hd), (2, h, hd), (2, h)))
    state = state[:2] + (jnp.abs(state[2]) + 0.5,) + state[3:]
    for s, st in ((16, None), (16, state), (1, state)):
        u = _input(rng, (2, s, cfg.d_model), prec)
        y, new = block(_t(u), None if st is None else _torch_state(st))
        fn = jblocks.slstm_apply if s > 1 else jblocks.slstm_decode
        jy, jnew = fn(p, u, jcfg, state=st) if s > 1 else fn(p, u, jcfg, st)
        _rel_close(y, jy, prec, f"y at S={s}")
        for got, want in zip(new, jnew):
            _rel_close(got, want, prec, f"state at S={s}")


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


def _cache_close(got, want, prec):
    """The port's flat cache against the reference's nested tree."""
    worst = 0.0
    assert len(jax.tree.leaves(want)) == len(CACHE_KEYS)
    for key, w in zip(CACHE_KEYS, jax.tree.leaves(want)):
        g = got[key]
        if key == "mlstm_conv" and prec == "fp32":
            np.testing.assert_allclose(_np(g), _np(w), rtol=2.0 ** -7, atol=1e-6, err_msg=key)
        else:
            worst = max(worst, _close(g, w, STATE_TOL[prec], key))
    return worst


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_model_against_the_reference(prec):
    """``loss``, the forward, ``prefill`` and 20 ``decode_step``s of the
    smoke model from the prefill's cache, against the reference's."""
    jcfg, params, model = _pair(prec)
    jm = jax_build_model(jcfg)
    assert isinstance(model, XLSTMModel) and (model.n_macro, model.m_per_macro) == (2, 1)
    toks = _tokens(jcfg, 1)
    labels = np.roll(toks, -1, axis=1)
    jloss, _ = jax.jit(jm.loss)(params, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    with torch.no_grad():
        loss, metrics = model.loss({"tokens": _t(toks), "labels": _t(labels)})
        logits = model(_t(toks))
    assert set(metrics) == {"xent"}
    _close(loss, jloss, LOSS_TOL[prec], "loss")
    # the forward's last logits are prefill's (fresh states either way)
    jlog, jcache = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks[:, :16])})
    with torch.no_grad():
        plog, cache = model.prefill({"tokens": _t(toks[:, :16])})
        head = model(_t(toks[:, :16]))
    assert plog.shape == (2, 1, jcfg.vocab)
    gaps = {"prefill": _close(plog, jlog, LOGIT_TOL[prec], "prefill logits"),
            "forward's last vs prefill": _close(head[:, -1:], plog, LOGIT_TOL[prec] / 10, "head")}
    gaps["prefill cache"] = _cache_close(cache, jcache, prec)
    assert {k: (v.shape, v.dtype) for k, v in cache.items()} == {
        k: (v.shape, v.dtype) for k, v in model.cache_shape(2, 0).items()}
    dec = jax.jit(jm.decode_step)
    worst = 0.0
    for t in range(20):
        tok = toks[:, 16 + t % 16:17 + t % 16]
        jlog, jcache = dec(params, jcache, {"tokens": jnp.asarray(tok),
                                            "pos": jnp.asarray(16 + t, jnp.int32)})
        before = {k: v.clone() for k, v in cache.items()}
        with torch.no_grad():
            dlog, cache_new = model.decode_step(cache, {"tokens": _t(tok), "pos": torch.tensor(16 + t)})
        assert all(torch.equal(before[k], cache[k]) for k in cache)  # the input is not written
        cache = cache_new
        worst = max(worst, _close(dlog, jlog, LOGIT_TOL[prec], f"decode step {t}"))
    gaps["decode"] = worst
    gaps["decode cache"] = _cache_close(cache, jcache, prec)
    jfull = jax.jit(lambda p, x: jtransformer._logits(
        p, jcommon.rms_norm(jm._run(p, p["embed"][x])[0], p["final_norm"], jcfg.norm_eps),
        jcfg))(params, jnp.asarray(toks))
    gaps["forward"] = _close(logits, jfull, LOGIT_TOL[prec], "forward logits")
    gaps["loss"] = abs(float(loss) - float(jloss))
    print(f"{prec}: {gaps}; logits max |x| {float(logits.abs().max()):.3f}")


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
    bf16: the reference's own bf16 gradients lie up to 0.166 (relative
    norm, mLSTM ``b_if``) from its fp32 ones on this batch, the recurrent
    gates' rounding carried through 32 steps, so the port's bf16 leaf is
    held to the reference's fp32 one instead, within 0.05 plus twice the
    reference's own bf16 gap on that leaf (measured: the port ≤ 0.073 of
    fp32, the reference ≤ 0.166; the port's to the reference's bf16 ≤ 0.153,
    reported)."""
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
    cfg, model = arch
    batch = make_batch(cfg, SMOKE_TRAIN, device="cpu")
    model = XLSTMModel(cfg, device="cpu")
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
    """Prefill's last logits match the same tokens decoded one by one."""
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


def test_cache_tree_crosses_packages_bitwise():
    """``cache_from_jax``/``cache_to_tree``: the reference's ``init_cache``
    and a prefill's cache carried into the port and back, every leaf bit for
    bit, in the reference's nested layout."""
    jcfg, params, model = _pair("bf16")
    jm = jax_build_model(jcfg)
    for tree in (jm.init_cache(3, 8),
                 jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(_tokens(jcfg, 4, s=8))})[1]):
        cache = cache_from_jax(model, jax.tree.map(np.asarray, tree))
        shapes = model.cache_shape(cache["slstm_h"].shape[1], 0)
        assert {k: (v.shape, v.dtype) for k, v in cache.items()} == {
            k: (v.shape, v.dtype) for k, v in shapes.items()}
        back = cache_to_tree(model, cache)
        assert (jax.tree.structure(jax.tree.map(lambda _: 0, back))
                == jax.tree.structure(jax.tree.map(lambda _: 0, tree)))
        for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            want = np.asarray(want)
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            assert np.array_equal(_t(want).view(torch.int16 if got.dtype == torch.bfloat16
                                                else got.dtype).numpy(),
                                  got.view(torch.int16 if got.dtype == torch.bfloat16
                                           else got.dtype).numpy())
    fresh = model.init_cache(3, 8)
    ref = cache_from_jax(model, jax.tree.map(np.asarray, jm.init_cache(3, 8)))
    assert all(torch.equal(fresh[k], ref[k]) for k in fresh)


def test_param_tree_layout_is_the_references():
    """Every leaf of the reference's ``init`` maps onto a parameter (names
    ``macros.<i>.mlstm.<j>.<leaf>``, ``macros.<i>.mlstm_ln.<j>``,
    ``macros.<i>.slstm.<leaf>``, ``macros.<i>.slstm_ln``) and back bit for
    bit, in the reference's dtypes."""
    jcfg, params, model = _pair("bf16")
    names = dict(model.named_parameters())
    assert "macros.1.mlstm.0.wq" in names and "macros.1.mlstm_ln.0" in names
    assert "macros.1.slstm.r" in names and "macros.1.slstm_ln" in names
    for leaf in ("mlstm.0.wif", "mlstm.0.b_if", "slstm.b"):
        assert names[f"macros.0.{leaf}"].dtype == torch.float32, leaf
    back = jax.tree_util.tree_flatten_with_path(to_tree(names))[0]
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [jax.tree_util.keystr(p) for p, _ in back] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, got), (_, w) in zip(back, want):
        w = np.asarray(w)
        assert tuple(got.shape) == w.shape, jax.tree_util.keystr(path)
        assert torch.equal(got.view(torch.int16) if got.dtype == torch.bfloat16 else got,
                           _t(w).view(torch.int16) if got.dtype == torch.bfloat16 else _t(w))
