"""The port's LM stack (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package on the same seeded inputs and the same weights.

The reference's ``init`` is carried into the port by
``models.convert.lm_params_from_jax``.  Tolerances:

- fp32 (the reference's parameters upcast in both packages, and the decode
  cache too): logits within 1e-4 (the same fp32 arithmetic, summed in
  another order; measured ≤ 2e-6), the decode cache within 1e-5.  With a
  bf16 cache an fp32 k a hair from a rounding boundary rounds the other way
  in one package, one bf16 ULP (rel 2^-8), which moved a logit by 5e-4; so
  prefill's bf16 cache is held within one bf16 ULP of its value (rel 2^-7).
- bf16 (as configured): logits within 0.1 absolute, caches within 0.0625.
  Measured on these inputs: logits ≤ 0.047, caches ≤ 0.031 (one or two bf16
  ULPs at |x| in [4, 8)).  The packages round intermediates in different
  places: XLA fuses an elementwise chain (silu·mul, the residual adds) and
  rounds once at the fusion's end, torch rounds every op's output to bf16.
- Primitives on fp32 inputs within 1e-5; on bf16 inputs within one bf16
  ULP of the output.  Chunked attention against dense within 2e-4, as
  ``tests/test_attention.py`` holds the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch.specs import make_batch
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import registry
from repro_torch.models import common
from repro_torch.models.api import build_model
from repro_torch.models.blocks import MLP, Attention
from repro_torch.models.common import ShapeSpec
from repro_torch.models.convert import lm_params_from_jax, tensor_from_numpy
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.recurrent import XLSTMModel, ZambaModel
from repro_torch.models.transformer import TransformerLM

torch.set_num_threads(1)

DENSE = ["qwen3_0_6b", "yi_6b", "deepseek_67b", "h2o_danube_3_4b"]
# the families TransformerLM refuses: xlstm is built by XLSTMModel, zamba2
# by ZambaModel and whisper by EncDecModel (their parity tests are
# tests/test_torch_xlstm*.py, tests/test_torch_zamba*.py and
# tests/test_torch_whisper*.py)
NOT_PORTED = ["xlstm_350m", "zamba2_7b", "whisper_medium"]
# the moe and vlm families: their parity tests are tests/test_torch_moe.py
ROUTED_AND_VLM = ["granite_moe_1b_a400m", "olmoe_1b_7b", "qwen2_vl_72b"]
LOGIT_TOL = {"fp32": 1e-4, "bf16": 0.1}
CACHE_TOL = {"fp32": 0.0, "bf16": 0.0625}  # fp32: one bf16 ULP, relative (below)
S_MAX = 16  # the decode cache; 20 steps run past its end (and wrap h2o's window)


def _np(t):
    """numpy fp32 of a jax array or a torch tensor."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    diff = float(np.abs(got - want).max()) if got.size else 0.0
    assert diff <= tol, f"{what}: max|diff| {diff} > {tol}"


def _cache_close(got, want, prec, what):
    got, want = _np(got), _np(want)
    if prec == "fp32":  # both round (nearly) the same fp32 values to bf16
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-5, err_msg=what)
    else:
        _close(got, want, CACHE_TOL[prec], what)


def _t(a):
    """A CPU tensor holding a copy of ``a`` (jax hands out read-only arrays)."""
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", jreg.ARCH_IDS)
def test_configs_equal_the_reference(name):
    for got, want in ((registry.get_config(name), jreg.get_config(name)),
                      (registry.get_smoke_config(name), jreg.get_smoke_config(name))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.hd == want.hd
        assert got.num_params() == want.num_params()
        assert got.num_active_params() == want.num_active_params()


def test_registry_names():
    assert registry.ARCH_IDS == jreg.ARCH_IDS and registry.ALIASES == jreg.ALIASES
    for alias in registry.ALIASES:
        assert registry.canonical(alias) == jreg.canonical(alias)
    assert registry.get_config("qwen3-0.6b").name == "qwen3-0.6b"
    assert set(registry.all_configs()) == set(jreg.ARCH_IDS)
    cfg = registry.override(registry.get_config("yi-6b"), attn_impl="dense")
    assert cfg.attn_impl == "dense" and cfg.n_layers == 32
    assert common.SHAPES == {k: ShapeSpec(**dataclasses.asdict(v))
                             for k, v in jcommon.SHAPES.items()}


@pytest.mark.parametrize("name", NOT_PORTED)
def test_build_model_refuses_families_not_ported(name):
    """The three families ``TransformerLM`` does not build are ported by
    other classes: the ssm family (xlstm) builds an ``XLSTMModel``, the
    hybrid family (zamba2) a ``ZambaModel`` and the audio family (whisper)
    an ``EncDecModel``.  ``TransformerLM`` refuses all three."""
    cfg = registry.get_smoke_config(name)
    want = {"xlstm_350m": XLSTMModel, "zamba2_7b": ZambaModel, "whisper_medium": EncDecModel}
    assert isinstance(build_model(cfg, device="cpu"), want[name])
    assert not common.NOT_PORTED
    with pytest.raises(NotImplementedError, match=cfg.family):
        TransformerLM(cfg, device="cpu")


def test_build_model_needs_a_device_or_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(registry.get_smoke_config("qwen3_0_6b"))


# --------------------------------------------------------------------- #
# primitives
# --------------------------------------------------------------------- #
def _bf16_ulp(x):
    return np.abs(_np(x)) * 2.0 ** -7 + 1e-30


def _both(rng, shape, dtype):
    a = rng.normal(0, 1, shape).astype(np.float32)
    if dtype == "bf16":
        j = jnp.asarray(a, jnp.bfloat16)
        return j, tensor_from_numpy(np.asarray(j))
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_norms(dtype):
    rng = np.random.default_rng(1)
    (jx, tx), (js, ts), (jb, tb) = (_both(rng, s, dtype) for s in ((3, 5, 48), (48,), (48,)))
    for got, want in ((common.rms_norm(tx, ts, 1e-6), jcommon.rms_norm(jx, js, 1e-6)),
                      (common.layer_norm(tx, ts, tb), jcommon.layer_norm(jx, js, jb))):
        assert got.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
        tol = 1e-5 if dtype == "fp32" else _bf16_ulp(want)
        assert (np.abs(_np(got) - _np(want)) <= tol).all()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rope_and_mrope(dtype):
    rng = np.random.default_rng(2)
    jx, tx = _both(rng, (2, 7, 3, 16), dtype)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    pos3 = rng.integers(0, 4096, (3, 2, 7)).astype(np.int32)
    for got, want in ((common.rope(tx, _t(pos), 1e6), jcommon.rope(jx, jnp.asarray(pos), 1e6)),
                      (common.mrope(tx, _t(pos3), 1e4),
                       jcommon.mrope(jx, jnp.asarray(pos3), 1e4))):
        # angles up to 4096 rad: one fp32 ULP of the angle moves sin/cos by ~5e-4
        tol = 2e-3 if dtype == "fp32" else _bf16_ulp(want) + 2e-3
        assert (np.abs(_np(got) - _np(want)) <= tol).all()
    small = rng.integers(0, 64, (2, 7)).astype(np.int32)
    _close(common.rope(tx.float(), _t(small), 1e4),
           jcommon.rope(jx.astype(jnp.float32), jnp.asarray(small), 1e4), 1e-5, "rope")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mlps(dtype):
    rng = np.random.default_rng(3)
    (jx, tx), (j1, t1), (j3, t3), (j2, t2), (jb1, tb1), (jb2, tb2) = (
        _both(rng, s, dtype) for s in ((4, 32), (32, 64), (32, 64), (64, 32), (64,), (32,)))
    for got, want in ((common.swiglu(tx, t1, t3, t2), jcommon.swiglu(jx, j1, j3, j2)),
                      (common.gelu_mlp(tx, t1, tb1, t2, tb2),
                       jcommon.gelu_mlp(jx, j1, jb1, j2, jb2))):
        # bf16: two ULPs of the output's scale (one rounding more or less
        # inside the chain; torch rounds silu's output, XLA's fusion does not)
        scale = float(np.abs(_np(want)).max())
        _close(got, want, 1e-4 * scale if dtype == "fp32" else 2.0 ** -6 * scale, "mlp")


def _qkv(rng, b, sq, sk, h, hkv, dh, dtype="fp32"):
    return [_both(rng, s, dtype) for s in ((b, sq, h, dh), (b, sk, hkv, dh), (b, sk, hkv, dh))]


@pytest.mark.parametrize("causal,window,hkv,qc,kc", [
    (True, None, 4, 16, 16),   # causal-skip path (sq == sk, n_q > 1)
    (True, None, 2, 32, 16),   # GQA + skip
    (True, 24, 4, 16, 16),     # sliding window (no skip)
    (False, None, 4, 16, 32),  # bidirectional
])
def test_attention_dense_and_chunked(causal, window, hkv, qc, kc):
    rng = np.random.default_rng(hkv * qc + kc)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, 64, 64, 4, hkv, 8)
    dense = common._attn_dense(tq, tk, tv, causal=causal, window=window)
    chunked = common._attn_chunked(tq, tk, tv, causal=causal, window=window,
                                   q_chunk=qc, k_chunk=kc)
    _close(dense, jcommon._attn_dense(jq, jk, jv, causal=causal, window=window), 1e-5, "dense")
    _close(chunked, jcommon._attn_chunked(jq, jk, jv, causal=causal, window=window,
                                          q_chunk=qc, k_chunk=kc), 1e-5, "chunked")
    _close(chunked, dense, 2e-4, "chunked vs dense")


def test_attention_bf16_and_q_offset():
    rng = np.random.default_rng(7)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 1, 32, 64, 4, 2, 16, "bf16")
    for offset in (0, 32):
        got = common._attn_chunked(tq, tk, tv, causal=True, window=None, q_chunk=16,
                                   k_chunk=16, q_offset=offset)
        want = jcommon._attn_chunked(jq, jk, jv, causal=True, window=None, q_chunk=16,
                                     k_chunk=16, q_offset=offset)
        assert got.dtype == torch.bfloat16
        assert (np.abs(_np(got) - _np(want)) <= _bf16_ulp(want) + 1e-6).all()
        got = common._attn_dense(tq, tk, tv, causal=True, window=8, q_offset=offset)
        want = jcommon._attn_dense(jq, jk, jv, causal=True, window=8, q_offset=offset)
        assert (np.abs(_np(got) - _np(want)) <= _bf16_ulp(want) + 1e-6).all()


def test_attention_dispatch_fallbacks():
    rng = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 1, 10, 10, 2, 2, 4)  # non-divisible: dense
    got = common.attention(tq, tk, tv, causal=True, impl="chunked", q_chunk=16, k_chunk=16)
    _close(got, common._attn_dense(tq, tk, tv, causal=True, window=None), 1e-5, "fallback")
    _close(got, jcommon.attention(jq, jk, jv, causal=True, impl="chunked", q_chunk=16,
                                  k_chunk=16), 1e-5, "vs reference")
    # auto: chunked only past 2048 on both axes
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 1, 2112, 2112, 1, 1, 4)
    got = common.attention(tq, tk, tv, q_chunk=1056, k_chunk=1056)
    want = common._attn_chunked(tq, tk, tv, causal=True, window=None, q_chunk=1056,
                                k_chunk=1056)
    assert torch.equal(got, want)
    _close(got, jcommon.attention(jq, jk, jv, q_chunk=1056, k_chunk=1056), 1e-5, "auto")


# --------------------------------------------------------------------- #
# blocks (attention alone, the GELU MLP)
# --------------------------------------------------------------------- #
def _load(module, tree):
    for name, arr in tree.items():
        getattr(module, name).data = tensor_from_numpy(np.asarray(arr)).clone()
    return module


def test_attention_block_and_gelu_mlp():
    cfg = jreg.get_smoke_config("qwen3_0_6b")
    gen = torch.Generator().manual_seed(0)
    p = jblocks.attn_init(jax.random.PRNGKey(1), cfg)
    attn = _load(Attention(registry.get_smoke_config("qwen3_0_6b"), gen), p)
    assert set(dict(attn.named_parameters())) == set(p)
    rng = np.random.default_rng(0)
    jx, tx = _both(rng, (2, 6, cfg.d_model), "bf16")
    pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    got, (gk, _) = attn(tx, _t(pos))
    want, (wk, _) = jblocks.attn_apply(p, jx, cfg, positions=jnp.asarray(pos))
    _close(got, want, 0.1, "attn_apply")
    _close(gk, wk, 0.0625, "attn_apply k")
    cache = {"k": jnp.zeros((2, 8, cfg.n_kv_heads, cfg.hd), jnp.bfloat16)}
    cache["v"] = cache["k"]
    tk, tv = (torch.zeros(2, 8, cfg.n_kv_heads, cfg.hd, dtype=torch.bfloat16) for _ in "kv")
    decode = jax.jit(jblocks.attn_decode, static_argnums=2)
    for t in range(10):  # past the 8-row cache from step 8 on
        pos = np.array([t, 2], np.int32)
        want, cache = decode(p, jx[:, t % 6:t % 6 + 1], cfg, cache, jnp.asarray(pos))
        got = attn.decode(tx[:, t % 6:t % 6 + 1], tk, tv, _t(pos))
        _close(got, want, 0.1, f"attn_decode step {t}")
        _close(tk, cache["k"], 0.0625, f"k cache step {t}")
        _close(tv, cache["v"], 0.0625, f"v cache step {t}")
    m = jblocks.mlp_init(jax.random.PRNGKey(2), cfg, gelu=True)
    mlp = _load(MLP(registry.get_smoke_config("qwen3_0_6b"), gen, gelu=True), m)
    assert set(dict(mlp.named_parameters())) == set(m)
    _close(mlp(tx), jblocks.mlp_apply(m, jx), 0.1, "gelu mlp")


# --------------------------------------------------------------------- #
# the dense models, the reference's weights carried across
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module", params=[(n, p) for n in DENSE for p in ("fp32", "bf16")],
                ids=lambda np_: f"{np_[0]}-{np_[1]}")
def pair(request):
    name, prec = request.param
    jcfg = jreg.get_smoke_config(name)
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    if prec == "fp32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    tm = lm_params_from_jax(build_model(registry.get_smoke_config(name), device="cpu"),
                            jax.tree.map(np.asarray, params))
    fns = dict(loss=jax.jit(jm.loss), prefill=jax.jit(jm.prefill),
               decode=jax.jit(jm.decode_step))
    return dict(cfg=jcfg, jm=jm, params=params, tm=tm, prec=prec, fns=fns)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def test_loss_forward(pair):
    cfg, tm, prec = pair["cfg"], pair["tm"], pair["prec"]
    toks, labels = _tokens(cfg, 2, 32, 1), _tokens(cfg, 2, 32, 2)
    mask = (np.random.default_rng(3).random((2, 32)) < 0.7).astype(np.float32)
    for loss_mask in (None, mask):
        jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
        tb = {"tokens": _t(toks), "labels": _t(labels)}
        if loss_mask is not None:
            jb["loss_mask"], tb["loss_mask"] = jnp.asarray(loss_mask), _t(loss_mask)
        want, wm = pair["fns"]["loss"](pair["params"], jb)
        got, gm = tm.loss(tb)
        # a mean of per-token xent: the logits' bound carries over
        _close(got, want, LOGIT_TOL[prec] * 0.25, "loss")
        _close(gm["xent"], wm["xent"], LOGIT_TOL[prec] * 0.25, "xent")
    _close(tm(tb["tokens"]), jm_logits(pair, toks), LOGIT_TOL[prec], "forward logits")


def jm_logits(pair, toks):
    """The reference's full-sequence logits (its ``loss`` without ``_xent``)."""
    jm, p, cfg = pair["jm"], pair["params"], pair["cfg"]
    h = p["embed"][jnp.asarray(toks)]
    pos = jnp.broadcast_to(jnp.arange(toks.shape[1], dtype=jnp.int32), toks.shape)
    h, _ = jm._run_layers(p, h, pos, None)
    from repro.models.transformer import _logits
    return _logits(p, jcommon.rms_norm(h, p["final_norm"], cfg.norm_eps), cfg)


def test_prefill_logits_and_cache(pair):
    cfg, tm, prec = pair["cfg"], pair["tm"], pair["prec"]
    toks = _tokens(cfg, 2, 24, 4)  # past h2o's 16-wide window: its cache keeps the last 16
    want, wc = pair["fns"]["prefill"](pair["params"], {"tokens": jnp.asarray(toks)})
    got, gc = tm.prefill({"tokens": _t(toks)})
    assert got.shape == (2, 1, cfg.vocab) and gc["k"].dtype == torch.bfloat16
    _close(got, want, LOGIT_TOL[prec], "prefill logits")
    for key in ("k", "v"):
        _cache_close(gc[key], wc[key], prec, f"prefill cache {key}")


def _decode_run(pair, pos_of):
    """20 decode steps from an empty (2, S_MAX) cache in both packages, the
    step's ``pos`` from ``pos_of(t)``; logits held every step, caches at the
    end.  Returns both caches after every step."""
    cfg, tm, prec = pair["cfg"], pair["tm"], pair["prec"]
    toks = _tokens(cfg, 2, 20, 5)
    jc, tc = pair["jm"].init_cache(2, S_MAX), tm.init_cache(2, S_MAX)
    if prec == "fp32":  # the cache upcast too, in both: no bf16 rounding of k, v
        jc = jax.tree.map(lambda a: a.astype(jnp.float32), jc)
        tc = {k: v.float() for k, v in tc.items()}
    history = []
    for t in range(20):
        pos = pos_of(t)
        want, jc = pair["fns"]["decode"](pair["params"], jc, {
            "tokens": jnp.asarray(toks[:, t:t + 1]), "pos": jnp.asarray(pos)})
        inp, before = tc, {k: v.clone() for k, v in tc.items()}
        got, tc = tm.decode_step(tc, {"tokens": _t(toks[:, t:t + 1]), "pos": _t(pos)})
        for k in before:  # decode_step leaves its input cache as it was
            assert torch.equal(inp[k], before[k])
        _close(got, want, LOGIT_TOL[prec], f"decode logits at pos {pos}")
        history.append((np.asarray(pos), jc, tc, before))
    for key in ("k", "v"):
        _cache_close(tc[key], jc[key], prec, f"decode cache {key}")
    return history


def test_decode_scalar_pos(pair):
    history = _decode_run(pair, lambda t: np.int32(t))
    if not pair["cfg"].sliding_window:  # pos ≥ S_MAX: the write is dropped in both
        for pos, jc, tc, before in history:
            if pos >= S_MAX:
                assert torch.equal(tc["k"], before["k"]) and torch.equal(tc["v"], before["v"])
                np.testing.assert_array_equal(_np(jc["k"]), _np(history[S_MAX - 1][1]["k"]))


def test_decode_vector_pos(pair):
    # row 0 runs past the cache's end (or round h2o's ring), row 1 lags behind
    history = _decode_run(pair, lambda t: np.array([t, t // 2], np.int32))
    if not pair["cfg"].sliding_window:
        pos, _, tc, before = history[-1]
        assert pos[0] >= S_MAX
        assert torch.equal(tc["k"][:, 0], before["k"][:, 0])  # row 0's write dropped
        assert not torch.equal(tc["k"][:, 1], before["k"][:, 1])


def test_ring_buffer_wraps():
    cfg = registry.get_smoke_config("h2o_danube_3_4b")
    tm = build_model(cfg, device="cpu")
    assert tm.cache_shape(3, 64)["k"].shape == (2, 3, cfg.sliding_window, 2, 16)
    assert tm.cache_shape(3, 8)["k"].shape[2] == 8


# --------------------------------------------------------------------- #
# mirrors of tests/test_arch_smoke.py (decode; prefill then decode)
# --------------------------------------------------------------------- #
SMOKE_DECODE = ShapeSpec("smoke_decode", seq_len=32, global_batch=2, kind="decode")


@pytest.mark.parametrize("name", DENSE + ROUTED_AND_VLM)
def test_arch_smoke_decode_step(name):
    cfg = registry.get_smoke_config(name)
    model = build_model(cfg, device="cpu")
    b = SMOKE_DECODE.global_batch
    cache = model.init_cache(b, SMOKE_DECODE.seq_len)
    jb = make_batch(jreg.get_smoke_config(name), jcommon.ShapeSpec(**dataclasses.asdict(
        SMOKE_DECODE)))
    batch = {"tokens": _t(jb["tokens"]), "pos": _t(jb["pos"])}
    logits, new_cache = model.decode_step(cache, batch)
    assert logits.shape == (b, 1, cfg.vocab)
    assert torch.isfinite(logits.float()).all(), cfg.name
    for key in cache:  # cache structure is preserved
        assert new_cache[key].shape == cache[key].shape
        assert new_cache[key].dtype == cache[key].dtype


@pytest.mark.parametrize("name", DENSE)
def test_arch_smoke_prefill_then_decode(name):
    """Prefill of S tokens, then the S tokens one by one through the cache:
    the last logits agree (bf16: within the bf16 bound above) and so do the
    caches; then greedy decoding goes on through the prefilled cache."""
    cfg = registry.get_smoke_config(name)
    model = build_model(cfg, device="cpu")
    b, s = 2, 16
    toks = _t(_tokens(cfg, b, s, 6))
    logits_p, cache_p = model.prefill({"tokens": toks})
    assert logits_p.shape == (b, 1, cfg.vocab) and torch.isfinite(logits_p.float()).all()
    cache = model.init_cache(b, 32)
    for t in range(s):
        logits_d, cache = model.decode_step(cache, {"tokens": toks[:, t:t + 1], "pos": t})
    _close(logits_d, logits_p, LOGIT_TOL["bf16"], "prefill vs decode")
    s_kv = cache_p["k"].shape[2]
    for key in ("k", "v"):
        _close(cache[key][:, :, :s_kv], cache_p[key], CACHE_TOL["bf16"], key)
    # the prefilled cache placed in a longer one decodes on
    placed = model.init_cache(b, 32)
    for key in placed:
        placed[key][:, :, :s_kv] = cache_p[key]
    nxt = logits_p.argmax(-1)
    a, _ = model.decode_step(placed, {"tokens": nxt, "pos": s})
    c, _ = model.decode_step(cache, {"tokens": nxt, "pos": s})
    _close(a, c, LOGIT_TOL["bf16"], "decode after prefill")


# --------------------------------------------------------------------- #
# the weight converter
# --------------------------------------------------------------------- #
def test_bf16_weights_round_trip_bitwise():
    jcfg = jreg.get_smoke_config("qwen3_0_6b")
    params = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(3)))
    tm = lm_params_from_jax(build_model(registry.get_smoke_config("qwen3_0_6b"),
                                        device="cpu"), params)
    names = dict(tm.named_parameters())
    assert {p.dtype for p in names.values()} == {torch.bfloat16}
    assert np.array_equal(names["embed"].view(torch.int16).numpy(),
                          params["embed"].view(np.int16))
    for l in range(jcfg.n_layers):
        for sub in ("wq", "wk", "wv", "wo", "q_norm", "k_norm"):
            got = names[f"layers.{l}.attn.{sub}"].view(torch.int16).numpy()
            assert np.array_equal(got, params["layers"]["attn"][sub][l].view(np.int16)), sub
        for sub in ("w1", "w3", "w2"):
            got = names[f"layers.{l}.mlp.{sub}"].view(torch.int16).numpy()
            assert np.array_equal(got, params["layers"]["mlp"][sub][l].view(np.int16)), sub
    # and back: the reference's arrays from the port's tensors, bit for bit
    back = np.asarray(jnp.asarray(names["lm_head"].float().numpy(), jnp.bfloat16))
    assert np.array_equal(back.view(np.int16), params["lm_head"].view(np.int16))


def test_converter_refuses_a_tree_that_does_not_fit():
    jcfg = jreg.get_smoke_config("yi_6b")
    params = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    model = build_model(registry.get_smoke_config("yi_6b"), device="cpu")
    with pytest.raises(ValueError, match="does not have"):
        lm_params_from_jax(model, {**params, "extra": np.zeros(1, np.float32)})
    with pytest.raises(KeyError, match="lm_head"):
        lm_params_from_jax(model, {k: v for k, v in params.items() if k != "lm_head"})
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_jax(model, {**params, "embed": params["embed"][:-1]})
