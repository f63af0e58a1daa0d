"""The port's continuous-batching ``ServeEngine`` (``repro_torch.serving.engine``).

Mirrors ``tests/test_serving.py``'s two engine tests against the port's
engine and model, then holds the port's engine to the reference's on the
reference's weights carried across: the same slots, ``steps`` and ``pos``
after every call, the cache on every live row and the logits of every
call.  Tolerances are ``tests/test_torch_lm.py``'s: with the parameters
upcast to fp32 (and the pool's cache, in both) logits within 1e-4 and the
tokens equal; as configured (bf16) logits within 0.1 and the cache within
0.0625.  In bf16 the argmax may flip where the reference's top-2 margin is
within twice the logits' bound; there the port's request takes the
reference's token, so both pools go on from the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models.api import build_model as jax_build_model
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.api import build_model
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.serving.engine import Request, ServeEngine

torch.set_num_threads(1)

LOGIT_TOL = {"fp32": 1e-4, "bf16": 0.1}
CACHE_TOL = {"fp32": 1e-5, "bf16": 0.0625}


@pytest.fixture(scope="module")
def small_model():
    cfg = get_smoke_config("qwen3-0.6b")
    return cfg, build_model(cfg, device="cpu")


def _sequential_greedy(model, prompt, max_new, s_max=64):
    """Reference: single-sequence greedy decode via decode_step."""
    cache = model.init_cache(1, s_max)
    logits = None
    pos = 0
    for tok in prompt:
        logits, cache = model.decode_step(
            cache, {"tokens": torch.full((1, 1), int(tok)), "pos": torch.tensor(pos)})
        pos += 1
    out = [int(torch.argmax(logits[0, -1]))]
    for _ in range(max_new - 1):
        logits, cache = model.decode_step(
            cache, {"tokens": torch.full((1, 1), out[-1]), "pos": torch.tensor(pos)})
        pos += 1
        out.append(int(torch.argmax(logits[0, -1])))
    return out


def test_engine_matches_sequential(small_model):
    cfg, model = small_model
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (3, 5, 4)]
    reqs = [Request(uid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)]
    engine = ServeEngine(model, max_batch=4, s_max=64)
    done = engine.run(reqs)
    assert len(done) == 3
    for req in done:
        want = _sequential_greedy(model, req.prompt, req.max_new)
        assert req.out == want, (req.uid, req.out, want)


def test_engine_handles_overflow_queue(small_model):
    cfg, model = small_model
    rng = np.random.default_rng(1)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=3), max_new=3)
            for i in range(5)]
    engine = ServeEngine(model, max_batch=2, s_max=32)
    done = engine.run(reqs)
    assert len(done) == 5  # waves drain through the 2-slot pool
    assert engine.prefill_calls == 15
    assert engine.decode_calls == engine.prefill_calls + engine.steps
    assert engine.batch_axes == {"k": 1, "v": 1}


def _recording(engine, calls, to_np):
    """Wrap ``engine._decode`` to keep every call's logits (as fp32 numpy)."""
    decode = engine._decode

    def run(*args):
        logits, cache = decode(*args)
        calls.append(to_np(logits))
        return logits, cache
    engine._decode = run


def _live(cache, pos, axis_s=2):
    """Per slot, the cache rows its own tokens wrote: positions < pos."""
    return [cache[:, b, :min(int(p), cache.shape[axis_s])] for b, p in enumerate(pos)]


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("name", ["qwen3_0_6b", "h2o_danube_3_4b"])
def test_engine_against_the_reference(name, prec):
    jcfg = jax_smoke_config(name)
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    if prec == "fp32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    model = lm_params_from_jax(build_model(get_smoke_config(name), device="cpu"),
                               jax.tree.map(np.asarray, params))
    s_max = 24  # the last request runs past it (its writes dropped; h2o's ring wraps)
    rng = np.random.default_rng(2)
    spec = [(rng.integers(0, jcfg.vocab, size=n), m) for n, m in
            ((3, 5), (6, 4), (2, 7), (5, 3), (4, 6), (12, 16))]
    jeng = JaxServeEngine(jm, params, max_batch=3, s_max=s_max)
    teng = ServeEngine(model, max_batch=3, s_max=s_max)
    if prec == "fp32":
        jeng.cache = jax.tree.map(lambda a: a.astype(jnp.float32), jeng.cache)
        teng.cache = {k: v.float() for k, v in teng.cache.items()}
    jcalls, tcalls = [], []
    _recording(jeng, jcalls, lambda x: np.asarray(x, np.float32))
    _recording(teng, tcalls, lambda x: x.float().numpy())
    jreqs = [JaxRequest(uid=i, prompt=p, max_new=m) for i, (p, m) in enumerate(spec)]
    treqs = [Request(uid=i, prompt=p, max_new=m) for i, (p, m) in enumerate(spec)]
    forced = 0

    def same_tokens(slot_of):
        """Hold the logits of the calls just made; where the argmax differs,
        the reference's top-2 margin at that row must be within 2·tol (two
        logits each off by ≤ tol can swap), and the port's request takes
        the reference's token so both pools go on from the same inputs."""
        nonlocal forced
        assert len(tcalls) == len(jcalls)
        for got, want in zip(tcalls, jcalls):
            assert np.abs(got - want).max() <= LOGIT_TOL[prec]
        for tr, jr in zip(treqs, jreqs):
            assert len(tr.out) == len(jr.out) and tr.out[:-1] == jr.out[:-1]
            if tr.out != jr.out:
                top2 = np.sort(jcalls[-1][slot_of[jr.uid], -1])[-2:]
                assert top2[1] - top2[0] <= 2 * LOGIT_TOL[prec], (jr.uid, top2)
                tr.out[-1] = jr.out[-1]
                forced += 1
        tcalls.clear()
        jcalls.clear()

    # drive both as run() does, comparing the state after every submit and step
    jpend, tpend = list(jreqs), list(treqs)
    while jpend or any(s is not None for s in jeng.slots):
        while jpend and jeng._free_slot() is not None:
            slot = jeng._free_slot()
            assert teng._free_slot() == slot
            jeng.submit(jpend[0])
            teng.submit(tpend.pop(0))
            same_tokens({jpend.pop(0).uid: slot})
        active = {r.uid: i for i, r in enumerate(jeng.slots) if r is not None}
        jeng.step()
        teng.step()
        same_tokens(active)
        assert teng.steps == jeng.steps
        np.testing.assert_array_equal(teng.pos, jeng.pos)
        assert [r and r.uid for r in teng.slots] == [r and r.uid for r in jeng.slots]
        for key in ("k", "v"):
            for got, want in zip(_live(teng.cache[key], teng.pos),
                                 _live(np.asarray(jeng.cache[key], np.float32), jeng.pos)):
                assert np.abs(got.float().numpy() - want).max() <= CACHE_TOL[prec]
    assert forced == 0 or prec == "bf16"
    assert [r.done for r in treqs] == [True] * len(spec)
    assert [len(r.out) for r in treqs] == [m for _, m in spec]
    assert teng.decode_calls == teng.prefill_calls + teng.steps
