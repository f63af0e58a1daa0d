"""The port's optimizer and train step (``repro_torch.training.optim``,
``repro_torch.training.trainer``) against the JAX package's.

First ``tests/test_training.py``'s four optimizer and trainer tests on an
``nn.Module`` twin of its ``ToyModel``; then the port held to the
reference on the same seeded inputs.  Tolerances (measured beside each):

- ``schedule``: within 1 fp32 ULP at every step of the sweep where the
  two packages' cosines agree.  The reference's fp32 cosine on the CPU is
  glibc's ``cosf`` (within 0.55 ULP), the port's the fp64 one rounded
  once; they differ by one ULP at 106 of 10,001 steps (measured), where
  the lr is held within that ULP's effect plus 3 of its own.
- ``update`` over 5 steps, fp32 state: without clipping the port's
  ``master``, ``m``, ``v`` equal the reference's (run op by op, as torch
  runs) bit for bit (measured).  With the clip on, the global norm's sums
  of squares run in fp64 in the port and in fp32 in the reference (within
  rtol 1e-6; measured 2.1e-7), so the scale and
  every clipped gradient differ by an ULP: ``master``, ``m``, ``v`` within
  rtol 1e-6, with a floor of 1e-6 of the leaf's largest value where a
  moment's two terms cancel (measured 5.9e-7).  The bf16 working params
  equal but where the masters round to different bf16 neighbours, which
  happens only within 1e-6 of a bf16 rounding tie (measured: none).
- 3 train steps of the qwen3 smoke config in both packages from the
  reference's ``init``, ``microbatches`` 1 and 2: fp32 losses within 1e-5
  (measured 9.5e-7), bf16 within 0.02 (measured 0.0022).  Masters per
  leaf: ||Δ|| over the leaf's movement from its init within 0.01 in fp32
  (measured 0.0042) and 0.2 in bf16 (measured 0.098).  An elementwise
  bound would not do: AdamW moves a weight whose gradient is near ``eps``
  by up to lr on the sign of a rounding (one embed element in fp32), and
  in bf16 torch rounds every op where XLA rounds a fused chain once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.configs import registry as jreg
from repro.models.api import build_model as jax_build_model
from repro.training import optim as joptim
from repro.training.trainer import make_train_step as jax_make_train_step
from repro_torch.configs import registry
from repro_torch.models.api import build_model
from repro_torch.models.convert import (lm_params_from_jax, opt_state_from_jax,
                                        tensor_from_numpy, to_tree)
from repro_torch.training import optim
from repro_torch.training.trainer import make_eval_step, make_train_step, split

torch.set_num_threads(1)

DENSE = ["qwen3_0_6b", "yi_6b", "deepseek_67b", "h2o_danube_3_4b"]
ROUTED_AND_VLM = ["granite_moe_1b_a400m", "olmoe_1b_7b", "qwen2_vl_72b"]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


class ToyModel(nn.Module):
    """``tests/test_training.py``'s ``ToyModel`` as a module: a linear
    model whose weight is scaled by a norm-named leaf (kept out of decay)."""

    def __init__(self, d=8, seed=0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.w = nn.Parameter(torch.randn(d, generator=gen) * 0.1)
        self.norm = nn.Parameter(torch.ones(d))

    def loss(self, batch):
        pred = batch["x"] @ (self.w * self.norm)
        loss = torch.mean((pred - batch["y"]) ** 2)
        return loss, {"xent": loss}


def _toy_batch(n=64, d=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    w = rng.normal(0, 1, d).astype(np.float32)
    return {"x": torch.from_numpy(x), "y": torch.from_numpy(x @ w)}


def _state(model):
    return optim.init_state(dict(model.named_parameters()))


# --------------------------------------------------------------------- #
# the mirrors of tests/test_training.py
# --------------------------------------------------------------------- #
def test_adamw_converges():
    model = ToyModel()
    state = _state(model)
    cfg = optim.OptConfig(lr=0.05, warmup_steps=5, total_steps=200, weight_decay=0.0)
    step = make_train_step(model, cfg)
    batch = _toy_batch()
    first = None
    for _ in range(200):
        state, loss, _ = step(state, batch)
        first = first if first is not None else float(loss)
    assert float(loss) < 0.01 * first
    assert int(state["step"]) == 200
    eval_loss, _ = make_eval_step(model)(batch)
    assert float(eval_loss) < 0.01 * first


# The reference's test also runs its ``unroll_micro`` arm (static slices in
# place of ``lax.scan``, an XLA partitioner workaround); the port's loop is
# the only arm, so only the scan arm has a counterpart.
@pytest.mark.parametrize("microbatches", [2, 4])
def test_microbatch_matches_full_batch_grads(microbatches):
    batch = _toy_batch(n=64)
    cfg = optim.OptConfig(lr=0.1, warmup_steps=0, total_steps=10)
    m1, mn = ToyModel(seed=1), ToyModel(seed=1)
    _, l1, _ = make_train_step(m1, cfg, microbatches=1)(_state(m1), batch)
    _, ln, _ = make_train_step(mn, cfg, microbatches=microbatches)(_state(mn), batch)
    np.testing.assert_allclose(float(l1), float(ln), rtol=1e-5)
    np.testing.assert_allclose(_np(m1.w), _np(mn.w), rtol=1e-4, atol=1e-5)


def test_weight_decay_mask():
    """Norm/bias-like leaves must not decay."""
    assert optim._decay_mask("layers/attn/wq")
    assert not optim._decay_mask("layers/ln1")
    assert not optim._decay_mask("final_norm")
    assert not optim._decay_mask("layers/mamba/a_log")
    assert optim.ref_path("layers.3.attn.wq") == "layers/attn/wq"
    assert optim.ref_path("final_norm") == "final_norm"


def test_schedule_shape():
    cfg = optim.OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    lr5 = float(optim.schedule(cfg, torch.tensor(5)))
    lr10 = float(optim.schedule(cfg, torch.tensor(10)))
    lr100 = float(optim.schedule(cfg, torch.tensor(100)))
    assert 0.4 < lr5 < 0.6  # mid-warmup
    assert lr10 > 0.9  # warmup done
    assert abs(lr100 - 0.1) < 1e-3  # cosine floor


def test_split_cuts_as_the_reference():
    b = {"tokens": torch.arange(24).reshape(4, 6), "pos": torch.tensor(3),
         "pos3": torch.arange(3 * 4 * 6).reshape(3, 4, 6)}
    parts = split(b, 2)
    assert [p["tokens"].tolist() for p in parts] == [b["tokens"][:2].tolist(),
                                                     b["tokens"][2:].tolist()]
    assert all(int(p["pos"]) == 3 for p in parts)
    assert torch.equal(parts[1]["pos3"], b["pos3"][:, 2:])
    with pytest.raises(ValueError, match="does not split"):
        split({"tokens": torch.zeros(5, 2)}, 2)


# --------------------------------------------------------------------- #
# against the reference
# --------------------------------------------------------------------- #
def _ulps(a, b):
    """|a − b| in fp32 ULPs of b."""
    a, b = np.float32(a), np.float32(b)
    return abs(float(a) - float(b)) / float(np.spacing(np.abs(b)))


@pytest.mark.parametrize("cfg", [optim.OptConfig(),
                                 optim.OptConfig(lr=3e-3, warmup_steps=10, total_steps=50),
                                 optim.OptConfig(lr=1.0, warmup_steps=0, total_steps=7)])
def test_schedule_equals_the_reference(cfg):
    """Within 1 fp32 ULP at every step where the two cosines agree.  The
    reference's fp32 ``cos`` on the CPU is glibc's ``cosf`` (within 0.55
    ULP, not always correctly rounded); the port's is rounded from fp64, so
    the CPU and the card agree.  Where the cosines differ (by one ULP), the
    lr may differ by that ULP times ``0.5·(1 − min_lr_frac)·lr`` plus half
    an ULP for each of the four roundings that follow, 3 ULPs of the lr."""
    jcfg = joptim.OptConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    steps = np.arange(cfg.total_steps + 1, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: joptim.schedule(jcfg, s))(jnp.asarray(steps)))
    got = np.array([float(optim.schedule(cfg, torch.tensor(int(s), dtype=torch.int32)))
                    for s in steps], np.float32)
    prog = np.clip((steps.astype(np.float32) - np.float32(cfg.warmup_steps))
                   / np.float32(max(cfg.total_steps - cfg.warmup_steps, 1)), 0, 1)
    arg = np.float32(np.pi) * prog.astype(np.float32)
    jcos = np.asarray(jnp.cos(jnp.asarray(arg)))
    tcos = np.cos(arg.astype(np.float64)).astype(np.float32)
    differ = 0
    for g, w, jc, tc in zip(got, want, jcos, tcos):
        ulp = float(np.spacing(np.abs(w)))
        bound = ulp
        if jc != tc:
            differ += 1
            bound = 3 * ulp + abs(float(jc) - float(tc)) * 0.5 * (1 - cfg.min_lr_frac) * cfg.lr
        assert abs(float(g) - float(w)) <= bound, (g, w)
    assert differ <= 0.02 * len(steps), differ  # measured: 106 of 10001 steps, 0 of 51, 0 of 8


# every _NO_DECAY token, an attention bias (which decays: no token matches),
# bf16 and fp32 leaves, stacked layers and single ones
_LEAVES = {
    "embed": ((32, 8), "bf16"), "final_norm": ((8,), "bf16"), "lm_head": ((8, 32), "bf16"),
    "frontend_proj": ((6, 8), "fp32"),
    "layers.attn.wq": ((8, 16), "bf16"), "layers.attn.bq": ((16,), "bf16"),
    "layers.attn.q_norm": ((4,), "bf16"), "layers.ln1": ((8,), "bf16"),
    "layers.mlp.w1": ((8, 12), "fp32"), "layers.mlp.bias": ((12,), "fp32"),
    "layers.mamba.a_log": ((4,), "fp32"), "layers.mamba.dt_bias": ((4,), "fp32"),
    "layers.mamba.d_skip": ((4,), "fp32"), "layers.slstm.b_if": ((8,), "fp32"),
    "layers.out.scale": ((8,), "fp32"),
}
N_LAYERS = 3


def _names():
    out = []
    for key, (shape, dt) in _LEAVES.items():
        if key.startswith("layers."):
            out += [(f"layers.{l}.{key[7:]}", key, l, shape, dt) for l in range(N_LAYERS)]
        else:
            out.append((key, key, None, shape, dt))
    return out


def _seeded(rng, scale):
    """(port flat dict, reference tree) of the same seeded values."""
    stacked = {}
    for key, (shape, dt) in _LEAVES.items():
        full = (N_LAYERS,) + shape if key.startswith("layers.") else shape
        a = rng.normal(0, scale, full).astype(np.float32)
        stacked[key] = np.asarray(jnp.asarray(a, jnp.bfloat16 if dt == "bf16" else jnp.float32))
    flat = {}
    for name, key, l, _, _ in _names():
        flat[name] = tensor_from_numpy(stacked[key] if l is None else stacked[key][l])
    tree = {}
    for key, arr in stacked.items():
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(arr)
    return flat, tree


def _tie_mismatches(got_bf16, want_bf16, master):
    """Elements whose bf16 params differ, and whether each master lies
    within 1e-6 (relative) of a bf16 rounding tie."""
    g, w = _np(got_bf16).ravel(), _np(want_bf16).ravel()
    x = _np(master).ravel().astype(np.float64)
    bad = np.flatnonzero(g != w)
    lo, hi = np.minimum(g[bad], w[bad]), np.maximum(g[bad], w[bad])
    tie = (lo.astype(np.float64) + hi) / 2
    near = np.abs(x[bad] - tie) <= 1e-6 * np.abs(tie)
    return len(bad), bool(near.all())


@pytest.mark.parametrize("clip", [1.0, 1e9], ids=["clipped", "unclipped"])
def test_update_equals_the_reference(clip):
    rng = np.random.default_rng(7)
    cfg = optim.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip)
    jcfg = joptim.OptConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    params, jparams = _seeded(rng, 1.0)
    dtypes = {n: p.dtype for n, p in params.items()}
    jdtypes = jax.tree.map(lambda a: a.dtype, jparams)
    state, jstate = optim.init_state(params), joptim.init_state(jparams)
    jupdate = lambda s, g: joptim.update(jcfg, s, g, jdtypes)  # noqa: E731  (op by op, see above)
    mismatched = 0
    for step in range(5):
        grads, jgrads = _seeded(rng, 0.5)
        norm, jnorm = optim.global_norm(grads), joptim.global_norm(jgrads)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
        assert (float(norm) > clip) == (clip == 1.0)  # the clip is on, or off
        new, state = optim.update(cfg, state, grads, dtypes)
        jnew, jstate = jupdate(jstate, jgrads)
        assert int(state["step"]) == int(jstate["step"]) == step + 1
        for key in ("master", "m", "v"):
            got = to_tree(state[key])
            for path, want in jax.tree_util.tree_flatten_with_path(jstate[key])[0]:
                node = got
                for k in path:
                    node = node[k.key]
                want = _np(want)
                np.testing.assert_allclose(_np(node), want, rtol=1e-6,
                                           atol=1e-6 * float(np.abs(want).max()),
                                           err_msg=f"{key} {jax.tree_util.keystr(path)}")
        got_params = to_tree(new)
        for path, want in jax.tree_util.tree_flatten_with_path(jnew)[0]:
            node, master = got_params, to_tree(state["master"])
            for k in path:
                node, master = node[k.key], master[k.key]
            assert node.dtype == tensor_from_numpy(np.asarray(want)).dtype
            if node.dtype == torch.float32:  # the masters themselves, held above
                assert torch.equal(node, master)
                continue
            n_bad, at_ties = _tie_mismatches(node, want, master)
            assert at_ties, f"{jax.tree_util.keystr(path)}: {n_bad} params off a tie"
            mismatched += n_bad
    assert mismatched == 0  # measured; a tie would be allowed above, and counted here


@pytest.mark.parametrize("name", DENSE + ROUTED_AND_VLM)
def test_decay_mask_equals_the_reference(name):
    params = jax_build_model(jreg.get_smoke_config(name)).init(jax.random.PRNGKey(0))
    want = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]:
        pstr = "/".join(str(getattr(k, "key", k)) for k in path)
        want[pstr] = joptim._decay_mask(pstr)
    model = build_model(registry.get_smoke_config(name), device="cpu")
    got = {optim.ref_path(n): optim._decay_mask(optim.ref_path(n))
           for n, _ in model.named_parameters()}
    assert got == want
    assert not got["final_norm"] and not got["layers/ln1"] and got["layers/attn/wq"]


# --------------------------------------------------------------------- #
# the train step, both packages from the reference's init
# --------------------------------------------------------------------- #
# (loss, masters' movement): |Δloss|, and per leaf ||Δmaster|| over ||master − init||
STEP_TOL = {"fp32": (1e-5, 0.01), "bf16": (0.02, 0.2)}


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_equals_the_reference(prec, microbatches):
    jcfg = jreg.get_smoke_config("qwen3_0_6b")
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    if prec == "fp32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    init = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    model = lm_params_from_jax(build_model(registry.get_smoke_config("qwen3_0_6b"),
                                           device="cpu"),
                               jax.tree.map(np.asarray, params))
    cfg = optim.OptConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    jcfg_opt = joptim.OptConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    jstate = joptim.init_state(params)
    state = opt_state_from_jax(model, jax.tree.map(np.asarray, jstate))
    jstep = jax.jit(jax_make_train_step(jm, jcfg_opt, microbatches=microbatches))
    step = make_train_step(model, cfg, microbatches=microbatches)
    rng = np.random.default_rng(11)
    loss_tol, move_tol = STEP_TOL[prec]
    for i in range(3):
        toks = rng.integers(0, jcfg.vocab, (4, 16)).astype(np.int32)
        labels = np.roll(toks, -1, axis=1)
        params, jstate, jloss, _ = jstep(params, jstate, {"tokens": jnp.asarray(toks),
                                                          "labels": jnp.asarray(labels)})
        state, loss, metrics = step(state, {"tokens": torch.from_numpy(toks),
                                            "labels": torch.from_numpy(labels)})
        assert abs(float(loss) - float(jloss)) <= loss_tol, (i, float(loss), float(jloss))
        assert set(metrics) == {"xent", "aux"}
    got = to_tree(state["master"])
    for path, want in jax.tree_util.tree_flatten_with_path(jstate["master"])[0]:
        node, start = got, init
        for k in path:
            node, start = node[k.key], start[k.key]
        want = _np(want)
        rel = np.linalg.norm(_np(node) - want) / np.linalg.norm(want - start)
        assert rel <= move_tol, (jax.tree_util.keystr(path), rel)
    # the working params are the masters cast to the model's dtypes
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), state["master"][name].to(p.dtype)), name
