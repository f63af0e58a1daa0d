"""The port's Whisper (the ``audio`` family) through its ``ServeEngine``,
its train step, ``launch/train.py`` and its checkpoints, against the JAX
package's, on whisper-medium's smoke config and the reference's ``init``
carried across (every bias, norm scale and ``frontend_proj`` set to seeded
non-zero values, as in ``tests/test_torch_whisper.py``).  Tolerances:

- ``ServeEngine`` against the reference's after every submit and step.  The
  engine's cross memory is ``init_cache``'s zeros in both packages (the
  reference's engine never prefills frames), so the cross attention
  gives ``bo`` alone.  fp32 (every leaf upcast, the cache bf16): logits
  within 1e-4 and every cache leaf within one bf16 ULP of its value, until
  a cached k or v has rounded to the other bf16 neighbour in one package;
  from then on the logits within ``FLIPPED_TOL`` and every leaf within
  ``FLIPPED_TOL`` of its largest |x| (measured: logits 1.2e-6, no leaf
  rounded otherwise).  bf16: logits within 0.1 (measured 0.031) and every
  leaf within 2^-5 of its largest |x| (measured 0.0067).
  Every row of every leaf is held, the idle slots' too.  In bf16 the
  argmax may flip where the reference's top-2 margin is within twice the
  logits' bound; there the port's request takes the reference's token.
- 3 train steps from the reference's ``init`` at ``microbatches`` 1 and 2:
  ``tests/test_torch_training.py``'s bounds, losses within 1e-5 (fp32) and
  0.02 (bf16), each leaf's master within 0.01 of its movement (fp32); in
  bf16 against the reference's fp32 run, within 0.2 plus twice the
  reference's own bf16 gap; the ``bk`` leaves whose gradient is rounding
  noise as ``ZERO_GRAD`` says.
- ``launch.train.main --arch whisper-medium --smoke``: the loss lists
  within 0.02 (``tests/test_torch_launch.py``'s bound), a checkpoint of
  either package resumed by the other; the parameter and optimizer trees
  cross the packages' checkpoints bit for bit.
- The full config under ``FakeTensorMode``: 812,576,768 parameters and the
  reference's cache bytes, exactly.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.configs import registry as jreg
from repro.launch import specs as jspecs
from repro.launch import train as jtrain
from repro.models import common as jcommon
from repro.models.api import build_model as jax_build_model
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro.training import optim as joptim
from repro.training.trainer import make_train_step as jax_make_train_step
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.launch import train
from repro_torch.models.api import build_model
from repro_torch.models.convert import (cache_to_tree, lm_params_from_jax, opt_state_from_jax,
                                        to_tree)
from repro_torch.models.encdec import DEC_MAX, EncDecModel
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.training import optim
from repro_torch.training.trainer import make_train_step
from test_torch_whisper import ZERO_GRAD, _np, _seeded, _t

torch.set_num_threads(1)

NAME = "whisper_medium"
STEP_TOL = {"fp32": (1e-5, 0.01), "bf16": (0.02, 0.2)}
LOGIT_TOL = {"fp32": 1e-4, "bf16": 0.1}
CACHE_TOL = 2.0 ** -5  # bf16: relative to the leaf's largest |x|
FLIPPED_TOL = 2e-2
# The ``bk`` leaves whose gradient is zero in exact arithmetic (ZERO_GRAD:
# no rotation follows them, so the softmax takes q·bk away): Adam turns each
# package's rounding noise into a step of its own sign, so their masters are
# held to move at most ZERO_MOVE x the summed lr of the 3 steps an element
# in both packages (measured ≤ 1.02 in bf16, 0.082 in fp32, where the noise
# sits below Adam's eps).
ZERO_MOVE = 1.5


def _pair(prec):
    jcfg = jreg.get_smoke_config(NAME)
    params = _seeded(jax_build_model(jcfg).init(jax.random.PRNGKey(0)), 1)
    if prec == "fp32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    model = lm_params_from_jax(build_model(registry.get_smoke_config(NAME), device="cpu"),
                               jax.tree.map(np.asarray, params))
    return jcfg, params, model


def _leaves(cache, jcache):
    return zip(jax.tree.leaves(cache_to_tree(EncDecModel, cache)), jax.tree.leaves(jcache))


def _cache_close(cache, jcache, prec, flipped=False):
    """fp32: every leaf within one bf16 ULP of its value, or, once a leaf
    has rounded otherwise, within ``FLIPPED_TOL`` of its largest |x|; bf16:
    within ``CACHE_TOL`` of its largest |x|.  Returns the worst relative
    gap."""
    worst = 0.0
    for got, want in _leaves(cache, jcache):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        rel = float(np.abs(_np(got) - _np(want)).max()) / (float(np.abs(_np(want)).max()) or 1.0)
        worst = max(worst, rel)
        if prec == "fp32" and not flipped:
            np.testing.assert_allclose(_np(got), _np(want), rtol=2.0 ** -7, atol=1e-6)
        else:
            assert rel <= (FLIPPED_TOL if prec == "fp32" else CACHE_TOL)
    return worst


def _flipped(cache, jcache):
    return any(not np.array_equal(_np(got), _np(want)) for got, want in _leaves(cache, jcache))


def _recording(engine, calls, to_np):
    decode = engine._decode

    def run(*args):
        logits, cache = decode(*args)
        calls.append(to_np(logits))
        return logits, cache
    engine._decode = run


# --------------------------------------------------------------------- #
# ServeEngine
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_engine_against_the_reference(prec):
    jcfg, params, model = _pair(prec)
    jm = jax_build_model(jcfg)
    rng = np.random.default_rng(2)
    spec = [(rng.integers(0, jcfg.vocab, size=n), m) for n, m in
            ((3, 5), (6, 4), (2, 7), (5, 3), (4, 6), (12, 9))]
    jeng = JaxServeEngine(jm, params, max_batch=3, s_max=24)
    teng = ServeEngine(model, max_batch=3, s_max=24)
    assert teng.batch_axes == {key: 1 for key in teng.cache}
    assert teng.cache["self_k"].shape[2] == DEC_MAX and teng.cache["cross_k"].shape[2] == 24
    jcalls, tcalls = [], []
    _recording(jeng, jcalls, lambda x: np.asarray(x, np.float32))
    _recording(teng, tcalls, lambda x: x.float().numpy())
    jreqs = [JaxRequest(uid=i, prompt=p, max_new=m) for i, (p, m) in enumerate(spec)]
    treqs = [Request(uid=i, prompt=p, max_new=m) for i, (p, m) in enumerate(spec)]
    forced, worst, flipped, states = 0, 0.0, False, 0.0

    def same_tokens(slot_of):
        nonlocal forced, worst
        assert len(tcalls) == len(jcalls)
        tol = FLIPPED_TOL if flipped and prec == "fp32" else LOGIT_TOL[prec]
        for got, want in zip(tcalls, jcalls):
            worst = max(worst, float(np.abs(got - want).max()))
            assert worst <= tol
        for tr, jr in zip(treqs, jreqs):
            assert len(tr.out) == len(jr.out) and tr.out[:-1] == jr.out[:-1]
            if tr.out != jr.out:
                top2 = np.sort(jcalls[-1][slot_of[jr.uid], -1])[-2:]
                assert top2[1] - top2[0] <= 2 * LOGIT_TOL[prec], (jr.uid, top2)
                tr.out[-1] = jr.out[-1]
                forced += 1
        tcalls.clear()
        jcalls.clear()

    jpend, tpend = list(jreqs), list(treqs)
    while jpend or any(s is not None for s in jeng.slots):
        while jpend and jeng._free_slot() is not None:
            slot = jeng._free_slot()
            assert teng._free_slot() == slot
            jeng.submit(jpend[0])
            teng.submit(tpend.pop(0))
            same_tokens({jpend.pop(0).uid: slot})
            states = max(states, _cache_close(teng.cache, jeng.cache, prec, flipped))
            flipped = flipped or _flipped(teng.cache, jeng.cache)
        active = {r.uid: i for i, r in enumerate(jeng.slots) if r is not None}
        jeng.step()
        teng.step()
        same_tokens(active)
        assert teng.steps == jeng.steps
        np.testing.assert_array_equal(teng.pos, jeng.pos)
        assert [r and r.uid for r in teng.slots] == [r and r.uid for r in jeng.slots]
        states = max(states, _cache_close(teng.cache, jeng.cache, prec, flipped))
        flipped = flipped or _flipped(teng.cache, jeng.cache)
    assert forced == 0 or prec == "bf16"
    assert [r.done for r in treqs] == [True] * len(spec)
    assert [len(r.out) for r in treqs] == [m for _, m in spec]
    assert teng.decode_calls == teng.prefill_calls + teng.steps
    assert not teng.cache["cross_k"].any() and not teng.cache["cross_v"].any()
    print(f"{prec}: logits max|diff| {worst}, cache {states}, {forced} tokens forced, "
          f"a bf16 leaf rounded otherwise: {flipped}")


# --------------------------------------------------------------------- #
# the train step
# --------------------------------------------------------------------- #
def _batches(jcfg):
    return [jspecs.make_batch(jcfg, jcommon.ShapeSpec("t", 32, 4, "train"), seed=11 + i)
            for i in range(3)]


def _ref_masters(params, jcfg, microbatches):
    """The reference's masters after its 3 steps from ``params``."""
    jm = jax_build_model(jcfg)
    step = jax.jit(jax_make_train_step(jm, joptim.OptConfig(lr=3e-3, warmup_steps=1,
                                                             total_steps=10),
                                       microbatches=microbatches))
    jstate, losses = joptim.init_state(params), []
    for jb in _batches(jcfg):
        params, jstate, jloss, _ = step(params, jstate, jb)
        losses.append(float(jloss))
    return jstate["master"], losses


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_equals_the_reference(microbatches, prec):
    """3 steps of 4 rows of 32 frames and 4 tokens in both packages from the
    reference's init.  fp32: each leaf's master within 0.01 of its movement
    from the reference's.  bf16: each leaf's port master held to the
    reference's fp32 run, within 0.2 plus twice the reference's own bf16
    gap on that leaf (the gaps printed: the port's, the reference's, the
    port's to the reference's bf16)."""
    jcfg, params, model = _pair(prec)
    init = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    cfg = optim.OptConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    state = opt_state_from_jax(model, jax.tree.map(np.asarray, joptim.init_state(params)))
    loss_tol, move_tol = STEP_TOL[prec]
    train_step = make_train_step(model, cfg, microbatches=microbatches)
    masters, jlosses = _ref_masters(params, jcfg, microbatches)
    for i, jb in enumerate(_batches(jcfg)):
        state, loss, metrics = train_step(state, {k: _t(v) for k, v in jb.items()})
        assert abs(float(loss) - jlosses[i]) <= loss_tol, (i, float(loss), jlosses[i])
        assert set(metrics) == {"xent"}
    got = to_tree(state["master"])
    masters32 = masters if prec == "fp32" else _ref_masters(
        jax.tree.map(lambda a: a.astype(jnp.float32), params), jcfg, microbatches)[0]
    worst = {}
    for path, want32 in jax.tree_util.tree_flatten_with_path(masters32)[0]:
        node, start, want = got, init, masters
        for k in path:
            node, start, want = node[k.key], start[k.key], want[k.key]
        node, want, want32 = _np(node), _np(want), _np(want32)
        move = np.linalg.norm(want32 - start)
        key = jax.tree_util.keystr(path)
        if key in ZERO_GRAD:
            steps_lr = sum(float(optim.schedule(cfg, torch.tensor(t))) for t in (1, 2, 3))
            moved = max(np.abs(node - start).max(), np.abs(want - start).max())
            assert moved <= ZERO_MOVE * steps_lr, (key, moved, steps_lr)
            continue
        port = float(np.linalg.norm(node - want32) / move)
        ref = float(np.linalg.norm(want - want32) / move)
        assert port <= move_tol + 2 * ref, (key, port, ref)
        worst[key] = (round(port, 3), round(ref, 3),
                      round(float(np.linalg.norm(node - want) / np.linalg.norm(want - start)), 3))
    top = sorted(worst.items(), key=lambda kv: kv[1], reverse=True)[:3]
    print(f"{prec} x{microbatches}: {top}")
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), state["master"][name].to(p.dtype)), name
        assert p.dtype == (torch.float32 if prec == "fp32" else torch.bfloat16), name


def test_decay_mask_is_the_references():
    """``optim``'s weight-decay mask reads the reference's path strings: the
    norms (``ln1``–``ln3``, ``enc_norm``, ``final_norm``) are not decayed,
    the biases, ``frontend_proj`` and the products are, as in the reference
    (its ``update`` on a tree of ones with zero gradients moves exactly the
    decayed leaves)."""
    jcfg, params, model = _pair("fp32")
    ones = jax.tree.map(jnp.ones_like, params)
    zero = jax.tree.map(jnp.zeros_like, ones)
    new, _ = joptim.update(joptim.OptConfig(lr=1.0, warmup_steps=0), joptim.init_state(ones),
                           zero, jax.tree.map(lambda a: a.dtype, ones))
    want = {jax.tree_util.keystr(p): bool((np.asarray(a) != 1).any())
            for p, a in jax.tree_util.tree_flatten_with_path(new)[0]}
    got = {}
    for name, _ in model.named_parameters():
        path = "".join(f"['{k}']" for k in optim.ref_path(name).split("/"))
        decayed = optim._decay_mask(optim.ref_path(name))
        assert got.setdefault(path, decayed) == decayed
    assert got == want
    assert not got["['enc_norm']"] and not got["['dec_layers']['ln3']"]
    assert got["['enc_layers']['attn']['bq']"] and got["['frontend_proj']"]
    assert got["['dec_layers']['xattn']['wk']"] and got["['enc_layers']['mlp']['b1']"]


# --------------------------------------------------------------------- #
# launch.train and checkpoints across packages
# --------------------------------------------------------------------- #
ARGS = ["--arch", "whisper-medium", "--smoke", "--steps", "4", "--batch", "4",
        "--seq", "16", "--ckpt-every", "2", "--log-every", "100"]


def test_train_main_resumes_across_packages(tmp_path):
    """``launch.train.main`` at whisper-medium's smoke config (16 frames and
    16 ramped tokens a row) in both packages from one step-0 checkpoint of
    the reference's init, then each package resuming the other's step-2
    checkpoint: losses within 0.02."""
    jm = jax_build_model(jreg.get_smoke_config(NAME))
    params = jm.init(jax.random.PRNGKey(0))
    jckpt.save(str(tmp_path / "init"), 0, {"params": params, "opt": joptim.init_state(params)})
    for d in ("ref", "port"):
        shutil.copytree(tmp_path / "init", tmp_path / d)
    ref = jtrain.main(ARGS + ["--ckpt-dir", str(tmp_path / "ref")])
    port = train.main(ARGS + ["--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert len(ref) == len(port) == 4
    np.testing.assert_allclose(port, ref, atol=0.02)
    for src in ("ref", "port"):
        shutil.rmtree(tmp_path / src / "step_00000004")
    by_port = train.main(ARGS + ["--ckpt-dir", str(tmp_path / "ref"), "--device", "cpu"])
    by_ref = jtrain.main(ARGS + ["--ckpt-dir", str(tmp_path / "port")])
    np.testing.assert_allclose(by_port, ref[2:], atol=0.02)
    np.testing.assert_allclose(by_ref, port[2:], atol=0.02)


def _bits(x):
    x = x if isinstance(x, torch.Tensor) else _t(x)
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x


def test_checkpoints_cross_packages_bitwise(tmp_path):
    """The reference's params and optimizer state (after one step, so the
    moments are not zero) saved by its manager and restored into the port
    by ``launch.train.restore_into``; the port's ``checkpoint_tree`` saved
    by its manager and restored by the reference's: every leaf bit for bit,
    the stacked ``enc_layers``/``dec_layers`` leaves and the unstacked
    ``enc_norm`` and ``frontend_proj`` included."""
    jcfg, params, model = _pair("bf16")
    jm = jax_build_model(jcfg)
    jstate = joptim.init_state(params)
    batch = jspecs.make_batch(jcfg, jcommon.ShapeSpec("t", 32, 2, "train"), seed=3)
    params, jstate, _, _ = jax.jit(jax_make_train_step(jm, joptim.OptConfig()))(
        params, jstate, batch)
    jckpt.save(str(tmp_path / "ref"), 1, {"params": params, "opt": jstate})
    state = train.restore_into(CheckpointManager(str(tmp_path / "ref")), model)
    tree = train.checkpoint_tree(model, state)
    want = jax.tree_util.tree_flatten_with_path({"params": params, "opt": jstate})[0]
    got = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, w), (_, g) in zip(want, got):
        assert torch.equal(_bits(g), _bits(np.asarray(w))), jax.tree_util.keystr(path)
    assert tree["params"]["dec_layers"]["xattn"]["wq"].shape[0] == jcfg.n_layers
    assert tree["params"]["enc_layers"]["mlp"]["b1"].shape[0] == jcfg.n_enc_layers
    CheckpointManager(str(tmp_path / "port")).save_sync(1, tree)
    back = jckpt.restore(str(tmp_path / "port"), 1, {"params": params, "opt": jstate})
    for (path, w), (_, g) in zip(want, jax.tree_util.tree_flatten_with_path(back)[0]):
        assert np.asarray(g).dtype == np.asarray(w).dtype, jax.tree_util.keystr(path)
        assert np.array_equal(np.asarray(g).reshape(-1).view(np.uint8),
                              np.asarray(w).reshape(-1).view(np.uint8)), \
            jax.tree_util.keystr(path)


def test_full_config_builds_without_storage():
    """``build_model(get_config("whisper-medium"))`` under ``FakeTensorMode``
    (shapes and dtypes, no storage): an ``EncDecModel`` of 24 encoder and 24
    decoder layers, every leaf's shape and dtype the reference's
    (``jax.eval_shape`` of its ``init``): 812,576,768 parameters.
    ``ArchConfig.num_params`` says 812,034,048: it leaves out the biases and
    the norm scales, the reference's and the port's alike.  The cache of 8
    slots over 1,500 frames is the reference's: the self k and v over
    ``DEC_MAX`` positions 805,306,368 B, the cross k and v 1,179,648,000 B."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = registry.get_config("whisper-medium")
    with FakeTensorMode():
        model = build_model(cfg, device="cpu")
        params = dict(model.named_parameters())
    assert isinstance(model, EncDecModel)
    assert (len(model.enc_layers), len(model.dec_layers)) == (24, 24)
    jm = jax_build_model(jreg.get_config("whisper-medium"))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    meta = to_tree({n: torch.empty(p.shape, dtype=p.dtype, device="meta")
                    for n, p in params.items()})
    assert (jax.tree.structure(jax.tree.map(lambda _: 0, meta))
            == jax.tree.structure(jax.tree.map(lambda _: 0, shapes)))
    for (path, w), (_, g) in zip(jax.tree_util.tree_flatten_with_path(shapes)[0],
                                 jax.tree_util.tree_flatten_with_path(meta)[0]):
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        assert str(g.dtype).split(".")[-1] == str(w.dtype), jax.tree_util.keystr(path)
    n = sum(p.numel() for p in params.values())
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == 812_576_768
    assert cfg.num_params() == 812_034_048
    cache = model.cache_shape(8, 1500)
    nbytes = {key: leaf.numel() * leaf.element_size() for key, leaf in cache.items()}
    want = jm.cache_shape(8, 1500)
    assert sum(nbytes.values()) == sum(s.size * s.dtype.itemsize
                                       for s in jax.tree.leaves(want))
    assert nbytes["self_k"] + nbytes["self_v"] == 805_306_368
    assert nbytes["cross_k"] + nbytes["cross_v"] == 1_179_648_000
