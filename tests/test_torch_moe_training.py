"""The port's ``moe`` and ``vlm`` families through its train step, its
``ServeEngine``, ``launch/train.py`` and its checkpoints, against the JAX
package's, on the smoke configs of granite-moe-1b-a400m, olmoe-1b-7b and
qwen2-vl-72b.

The routing of every MoE call is recorded in both packages and compared as
``tests/test_torch_moe.py`` explains (``tests/_torch_routing.py``): top-k
sets equal wherever the reference's k-th/(k+1)-th gap is at least 1e-5
(fp32) or 1e-2 (bf16); a flip below it taints what it reaches, which is left
out and counted.  Tolerances:

- 3 train steps from the reference's ``init``, ``microbatches`` 1 and 2:
  ``tests/test_torch_training.py``'s, losses within 1e-5 (fp32) and 0.02
  (bf16), each leaf's master within 0.01 (fp32) and 0.2 (bf16) of its
  movement.  A step whose forward flipped a choice in either package is run
  again from the same state on a ``loss_mask`` without the tainted
  positions, in both.
- ``ServeEngine`` against the reference's after every submit and step:
  ``tests/test_torch_serve_lm.py``'s, logits within 1e-4 (fp32) and 0.1
  (bf16), the cache within 1e-5 and 0.0625, on every request no flip has
  reached (a tainted request takes the reference's tokens, so both pools
  go on from the same inputs).
- The decode step's capacity is shared by the pool's slots, as in the
  reference: one group of B tokens, ``cap = 5`` at B = 8 for these configs.
- ``launch.train.main`` at granite-moe's smoke config: the loss lists within
  0.02 (``tests/test_torch_launch.py``'s bound), a checkpoint of either
  package resumed by the other; the parameter and optimizer trees of the
  three configs cross the packages' checkpoints bit for bit.
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
from repro_torch.models.convert import (lm_params_from_jax, opt_state_from_jax,
                                        tensor_from_numpy, to_tree)
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.training import optim
from repro_torch.training.trainer import make_train_step

from _torch_routing import Routing, _few, _np, flips

torch.set_num_threads(1)

MOE = ["granite_moe_1b_a400m", "olmoe_1b_7b"]
FAMILIES = MOE + ["qwen2_vl_72b"]
STEP_TOL = {"fp32": (1e-5, 0.01), "bf16": (0.02, 0.2)}
LOGIT_TOL = {"fp32": 1e-4, "bf16": 0.1}
CACHE_TOL = {"fp32": 1e-5, "bf16": 0.0625}


def _t(a):
    return tensor_from_numpy(np.asarray(a))


def _pair(name, prec):
    jcfg = jreg.get_smoke_config(name)
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    if prec == "fp32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    model = lm_params_from_jax(build_model(registry.get_smoke_config(name), device="cpu"),
                               jax.tree.map(np.asarray, params))
    return jcfg, params, model


# --------------------------------------------------------------------- #
# the train step
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_equals_the_reference(name, microbatches, prec):
    jcfg, params, model = _pair(name, prec)
    init = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    cfg = optim.OptConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    jstate = joptim.init_state(params)
    state = opt_state_from_jax(model, jax.tree.map(np.asarray, jstate))
    loss_tol, move_tol = STEP_TOL[prec]
    moe = jcfg.family == "moe"
    b = 4
    calls = (2 if jcfg.remat == "full" else 1) * jcfg.n_layers  # route calls a microbatch
    rows = lambda i: slice(i // calls * b // microbatches,  # noqa: E731
                           (i // calls + 1) * b // microbatches)
    n_flips = n_routed = 0
    with Routing(params, model) as rec:
        jm = jax_build_model(jcfg)
        step = jax.jit(jax_make_train_step(jm, joptim.OptConfig(lr=3e-3, warmup_steps=1,
                                                                 total_steps=10),
                                           microbatches=microbatches))
        train_step = make_train_step(model, cfg, microbatches=microbatches)
        for i in range(3):
            jb = dict(jspecs.make_batch(jcfg, jcommon.ShapeSpec("t", 16, b, "train"), seed=11 + i))
            if prec == "fp32" and "vis_embeds" in jb:
                jb["vis_embeds"] = jb["vis_embeds"].astype(jnp.float32)
            jb["loss_mask"] = jnp.ones(jb["labels"].shape, jnp.float32)
            before = (params, jstate, state, {n: p.detach().clone()
                                              for n, p in model.named_parameters()})
            for attempt in range(2):
                tb = {k: _t(v) for k, v in jb.items()}
                params, jstate, jloss, _ = step(before[0], before[1], jb)
                state, loss, metrics = train_step(before[2], tb)
                if not moe:
                    break
                taint = np.zeros(jb["labels"].shape, bool)
                found, n, _ = flips(rec.take(), jcfg.moe.top_k, prec, taint, rows=rows)
                if attempt:
                    break
                n_flips, n_routed = n_flips + len(found), n_routed + n
                if not found:
                    break
                jb["loss_mask"] = jnp.asarray(~taint, jnp.float32)
                with torch.no_grad():
                    for n_, p in model.named_parameters():
                        p.copy_(before[3][n_])
            assert abs(float(loss) - float(jloss)) <= loss_tol, (i, float(loss), float(jloss))
            assert set(metrics) == {"xent", "aux"}
            if moe:
                assert 0 < float(metrics["aux"]) <= jcfg.moe.num_experts
    if prec == "fp32":
        assert n_flips == 0
    print(f"{name} {prec} microbatches {microbatches}: {n_flips} flips")
    _few(n_flips, max(n_routed, 1))
    got = to_tree(state["master"])
    for path, want in jax.tree_util.tree_flatten_with_path(jstate["master"])[0]:
        node, start = got, init
        for k in path:
            node, start = node[k.key], start[k.key]
        want = _np(want)
        rel = np.linalg.norm(_np(node) - want) / np.linalg.norm(want - start)
        assert rel <= move_tol, (jax.tree_util.keystr(path), rel)
    for name_, p in model.named_parameters():  # the router stays fp32
        assert torch.equal(p.detach(), state["master"][name_].to(p.dtype)), name_
        if name_.endswith("router"):
            assert p.dtype == torch.float32


# --------------------------------------------------------------------- #
# ServeEngine
# --------------------------------------------------------------------- #
def _recording(engine, calls, to_np):
    decode = engine._decode

    def run(*args):
        logits, cache = decode(*args)
        calls.append(to_np(logits))
        return logits, cache
    engine._decode = run


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_engine_against_the_reference(name, prec):
    """``tests/test_torch_serve_lm.py``'s engine test at these configs: the
    same slots, steps and positions after every call, the logits of every
    call and the live cache rows, on the requests no flip has reached.
    The vlm serves text prompts: no ``pos3``, so 1-D RoPE, as there."""
    jcfg, params, model = _pair(name, prec)
    s_max = 24
    rng = np.random.default_rng(2)
    spec = [(rng.integers(0, jcfg.vocab, size=n), m) for n, m in
            ((3, 5), (6, 4), (2, 7), (5, 3), (4, 6), (12, 16))]
    moe = jcfg.family == "moe"
    with Routing(params, model) as rec:
        jeng = JaxServeEngine(jax_build_model(jcfg), params, max_batch=3, s_max=s_max)
        teng = ServeEngine(model, max_batch=3, s_max=s_max)
        if prec == "fp32":
            jeng.cache = jax.tree.map(lambda a: a.astype(jnp.float32), jeng.cache)
            teng.cache = {k: v.float() for k, v in teng.cache.items()}
        jcalls, tcalls = [], []
        _recording(jeng, jcalls, lambda x: np.asarray(x, np.float32))
        _recording(teng, tcalls, lambda x: x.float().numpy())
        jreqs = [JaxRequest(uid=i, prompt=p, max_new=m) for i, (p, m) in enumerate(spec)]
        treqs = [Request(uid=i, prompt=p, max_new=m) for i, (p, m) in enumerate(spec)]
        tainted, n_flips, n_routed = set(), 0, 0

        def check(slot_of, adopted):
            """Hold the calls just made on the untainted requests; a flip in
            an adopted slot's row taints that slot's request (cap = B = 3:
            no row moves another's slot)."""
            nonlocal n_flips, n_routed
            if moe:
                for _ in range(len(tcalls)):
                    taint = np.zeros((1, teng.b), bool)
                    found, n, _ = flips(_one_call(rec), jcfg.moe.top_k, prec, taint,
                                        spread=False)
                    n_flips, n_routed = n_flips + len(found), n_routed + n
                    tainted.update(uid for uid, s in slot_of.items()
                                   if taint[0, s] and s in adopted)
            for got, want in zip(tcalls, jcalls):
                for uid, s in slot_of.items():
                    if uid not in tainted:
                        assert np.abs(got[s] - want[s]).max() <= LOGIT_TOL[prec], uid
            for tr, jr in zip(treqs, jreqs):
                assert len(tr.out) == len(jr.out) and tr.out[:-1] == jr.out[:-1]
                if tr.out != jr.out:
                    top2 = np.sort(jcalls[-1][slot_of[jr.uid], -1])[-2:]
                    assert jr.uid in tainted or top2[1] - top2[0] <= 2 * LOGIT_TOL[prec]
                    tr.out[-1] = jr.out[-1]
            tcalls.clear()
            jcalls.clear()

        jpend, tpend = list(jreqs), list(treqs)
        while jpend or any(s is not None for s in jeng.slots):
            while jpend and jeng._free_slot() is not None:
                slot = jeng._free_slot()
                assert teng._free_slot() == slot
                jeng.submit(jpend[0])
                teng.submit(tpend.pop(0))
                check({jpend.pop(0).uid: slot}, {slot})
            active = {r.uid: i for i, r in enumerate(jeng.slots) if r is not None}
            jeng.step()
            teng.step()
            check(active, set(active.values()))
            assert teng.steps == jeng.steps
            np.testing.assert_array_equal(teng.pos, jeng.pos)
            assert [r and r.uid for r in teng.slots] == [r and r.uid for r in jeng.slots]
            for key in ("k", "v"):
                for s, (got, want) in enumerate(zip(teng.cache[key].unbind(1),
                                                    np.asarray(jeng.cache[key], np.float32)
                                                    .swapaxes(0, 1))):
                    live = int(min(teng.pos[s], s_max))
                    req = teng.slots[s]
                    if req is None or req.uid in tainted:
                        continue
                    diff = np.abs(got[:, :live].float().numpy() - want[:, :live]).max()
                    assert diff <= CACHE_TOL[prec], (key, s)
    print(f"{name} {prec}: {n_flips} flips, {len(tainted)} of {len(spec)} requests tainted")
    if prec == "fp32":
        assert n_flips == 0
    _few(n_flips, max(n_routed, 1))
    assert [r.done for r in treqs] == [True] * len(spec)
    assert [len(r.out) for r in treqs] == [m for _, m in spec]
    assert teng.decode_calls == teng.prefill_calls + teng.steps


def _one_call(rec):
    """The records of one decode call: both packages' records of its
    layers, taken in call order (each call is awaited before the next)."""
    if not hasattr(rec, "pending"):
        rec.pending = ([], [])
    ref, port = rec.take()
    rec.pending = (rec.pending[0] + ref, rec.pending[1] + port)
    n_layers = len(rec.cols)
    one = (rec.pending[0][:n_layers], rec.pending[1][:n_layers])
    rec.pending = (rec.pending[0][n_layers:], rec.pending[1][n_layers:])
    return one


@pytest.mark.parametrize("name", MOE)
def test_pool_slots_share_the_decode_capacity(name):
    """The pooled decode step routes the pool's B tokens as ONE group, as
    the reference's does: at B = 8 the smoke configs (E 4 or 8, top-2) give
    ``cap = min(8, max(4, int(1.25·8·2/E)))``.  With the same token at the
    same position in every slot all slots route alike and the slots from
    ``cap`` on are dropped from every expert: their outputs differ from the
    lower slots' on the same input.  A different token in slot 0 frees a
    place, and the first dropped slot's logits change though its own input
    did not.  Both packages agree in both cases (fp32, within 1e-4)."""
    jcfg, params, model = _pair(name, "fp32")
    jm = jax_build_model(jcfg)
    b = 8
    cap = min(b, max(4, int(jcfg.moe.capacity_factor * b * jcfg.moe.top_k
                            / jcfg.moe.num_experts)))
    assert cap < b

    def both(tokens):
        batch = {"tokens": tokens[:, None].astype(np.int32), "pos": np.int32(0)}
        want, _ = jm.decode_step(params, jax.tree.map(lambda a: a.astype(jnp.float32),
                                                      jm.init_cache(b, 8)),
                                 jax.tree.map(jnp.asarray, batch))
        got, _ = model.decode_step({k: v.float() for k, v in model.init_cache(b, 8).items()},
                                   {k: _t(v) for k, v in batch.items()})
        got, want = _np(got)[:, 0], np.asarray(want, np.float32)[:, 0]
        assert np.abs(got - want).max() <= 1e-4
        return got, want

    same = np.full(b, 3)
    got, want = both(same)
    for out in (got, want):
        assert np.abs(out[:cap] - out[0]).max() <= 1e-6  # kept slots alike
        assert np.abs(out[cap:] - out[cap]).max() <= 1e-6  # dropped slots alike
        assert np.abs(out[cap - 1] - out[cap]).max() > 1e-3  # ... and not alike each other
    moved = None
    for other in range(jcfg.vocab):
        tokens = same.copy()
        tokens[0] = other
        g2, w2 = both(tokens)
        if np.abs(g2[cap] - got[cap]).max() > 1e-3:
            moved = (g2, w2)
            break
    assert moved is not None, "no token in slot 0 frees a place for slot cap"
    assert np.abs(moved[1][cap] - want[cap]).max() > 1e-3  # the reference moves alike


# --------------------------------------------------------------------- #
# launch.train and checkpoints across packages
# --------------------------------------------------------------------- #
ARGS = ["--arch", "granite-moe-1b-a400m", "--smoke", "--steps", "4", "--batch", "4",
        "--seq", "16", "--ckpt-every", "2", "--log-every", "100"]


def test_train_main_resumes_across_packages(tmp_path):
    """``launch.train.main`` at granite-moe's smoke config in both packages
    from one step-0 checkpoint of the reference's init, then each package
    resuming the other's step-2 checkpoint: losses within 0.02."""
    jm = jax_build_model(jreg.get_smoke_config("granite_moe_1b_a400m"))
    params = jm.init(jax.random.PRNGKey(0))
    jckpt.save(str(tmp_path / "init"), 0, {"params": params, "opt": joptim.init_state(params)})
    for d in ("ref", "port"):
        shutil.copytree(tmp_path / "init", tmp_path / d)
    ref = jtrain.main(ARGS + ["--ckpt-dir", str(tmp_path / "ref")])
    port = train.main(ARGS + ["--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])
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


@pytest.mark.parametrize("name", FAMILIES)
def test_checkpoints_cross_packages_bitwise(name, tmp_path):
    """The reference's params and optimizer state (after one step, so the
    moments are not zero) saved by its manager and restored into the port
    by ``launch.train.restore_into``; the port's ``checkpoint_tree`` saved
    by its manager and restored by the reference's: every leaf bit for bit,
    the 3-D experts, the fp32 router and ``frontend_proj`` included."""
    jcfg, params, model = _pair(name, "bf16")
    jm = jax_build_model(jcfg)
    jstate = joptim.init_state(params)
    batch = jspecs.make_batch(jcfg, jcommon.ShapeSpec("t", 16, 2, "train"), seed=3)
    params, jstate, _, _ = jax.jit(jax_make_train_step(jm, joptim.OptConfig()))(
        params, jstate, batch)
    jckpt.save(str(tmp_path / "ref"), 1, {"params": params, "opt": jstate})
    state = train.restore_into(CheckpointManager(str(tmp_path / "ref")), model)
    tree = train.checkpoint_tree(model, state)
    for (path, want), (_, got) in zip(
            jax.tree_util.tree_flatten_with_path({"params": params, "opt": jstate})[0],
            jax.tree_util.tree_flatten_with_path(tree)[0]):
        assert torch.equal(_bits(got), _bits(np.asarray(want))), jax.tree_util.keystr(path)
    assert dict(model.named_parameters())[
        "layers.0.moe.router" if name in MOE else "frontend_proj"].dtype == (
        torch.float32 if name in MOE else torch.bfloat16)
    CheckpointManager(str(tmp_path / "port")).save_sync(1, tree)
    back = jckpt.restore(str(tmp_path / "port"), 1, {"params": params, "opt": jstate})
    for (path, want), (_, got) in zip(
            jax.tree_util.tree_flatten_with_path({"params": params, "opt": jstate})[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        assert np.asarray(got).dtype == np.asarray(want).dtype, jax.tree_util.keystr(path)
        assert np.array_equal(np.asarray(got).reshape(-1).view(np.uint8),
                              np.asarray(want).reshape(-1).view(np.uint8)), \
            jax.tree_util.keystr(path)


def test_train_main_trains_the_vlm(tmp_path):
    """``launch.train.main --arch qwen2-vl-72b --smoke`` runs on the CPU and
    resumes its own checkpoint (the reference's ``main`` refuses this config:
    its synthetic batch ramps ``seq`` text tokens against a ``pos3`` of
    ``seq`` positions); the batch's patch embeddings and ``pos3`` are the
    reference's bytes, its text ramp the reference's cut to the text."""
    cfg, jcfg = registry.get_smoke_config("qwen2_vl_72b"), jreg.get_smoke_config("qwen2_vl_72b")
    b, jb = train.synthetic_batch(cfg, 4, 16, 3, device="cpu"), jtrain.synthetic_batch(jcfg, 4,
                                                                                       16, 3)
    assert list(b) == list(jb)
    for k in ("vis_embeds", "pos3"):
        assert torch.equal(_bits(b[k]), _bits(np.asarray(jb[k])))
    s_text = b["tokens"].shape[1]
    assert s_text == 12 and jb["tokens"].shape[1] == 16
    for k in ("tokens", "labels"):
        assert np.array_equal(b[k].numpy(), np.asarray(jb[k])[:, :s_text])
    args = ["--arch", "qwen2-vl-72b", "--smoke", "--steps", "6", "--batch", "4", "--seq", "16",
            "--ckpt-every", "3", "--log-every", "100", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "run")]
    losses = train.main(args)
    assert len(losses) == 6 and losses[-1] < losses[0]
    shutil.rmtree(tmp_path / "run" / "step_00000006")
    assert train.main(args) == losses[3:]


def test_full_configs_build_without_storage():
    """``build_model`` builds the three full configs (qwen2-vl-72b's 72.7 B
    parameters included) under ``FakeTensorMode``, which keeps shapes and
    dtypes and allocates nothing: the parameter count is
    ``ArchConfig.num_params`` plus ``final_norm``, which it leaves out;
    the routers are fp32, every other leaf bf16."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    for name in FAMILIES:
        cfg = registry.get_config(name)
        with FakeTensorMode():
            model = build_model(cfg, device="cpu")
            params = dict(model.named_parameters())
        assert sum(p.numel() for p in params.values()) == cfg.num_params() + cfg.d_model
        for n, p in params.items():
            assert p.dtype == (torch.float32 if n.endswith("router") else torch.bfloat16), n
        assert ("frontend_proj" in params) == (cfg.family == "vlm")
        if cfg.moe:
            e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert
            assert params["layers.0.moe.w1"].shape == (e, d, f)
            assert params["layers.0.moe.w2"].shape == (e, f, d)
