"""The port's ``moe`` and ``vlm`` families of ``TransformerLM`` against the
JAX package, on the reference's ``init`` carried across by
``lm_params_from_jax``: the MoE block (``MoE`` against ``moe_apply``), the
whole models' ``loss``, ``prefill``, ``decode_step``, gradients and
``remat``, for the smoke configs of granite-moe-1b-a400m, olmoe-1b-7b and
qwen2-vl-72b, in fp32 (every parameter upcast) and bf16 (as configured).

Routing.  The router's top-k is a discrete choice: where the k-th and
(k+1)-th gates of a token are nearly tied, two packages that round the
router's input or its fp32 product differently may choose differently, and
the token's MoE output then differs by O(1) — a tie broken the other way,
not an error.  So every comparison records the routing of every MoE call in
both packages (``tests/_torch_routing.py``: the reference's through a
wrapper of ``_moe_grouped`` that sends its gates to the host, the port's
through ``MoE.route``):

- Top-k sets must be equal on every token whose reference gap between the
  k-th and (k+1)-th gate is at least ``FLIP_GAP``; a token below it that
  chose differently is a flip, and each test prints how many it found.
  ``FLIP_GAP`` is 1e-5 where both packages see the same input (the block
  tests, and fp32 models, whose hidden states agree within 1e-6), and 1e-2
  for bf16 models: there torch rounds every op's output to bf16 where XLA
  rounds a fused chain once, so a layer's router input differs by bf16
  ULPs and its gates by up to 5.5e-3 (measured on these configs; two gates
  moving apart can swap across twice that).
- A flip taints what it can reach, which is left out of the elementwise
  holds and counted: in a sequence, its row from the flipped token on (the
  later tokens see it through attention, and its place in the capacity
  cumsum moves theirs); in a decode step (one group of B tokens), its row
  from that step on (and the later rows of that step where capacity can
  drop a token).  Losses and gradients are held on a ``loss_mask`` that
  leaves the tainted positions out, in both packages, after a first pass
  with a mask of ones (the same traced programs, so the same routing).
  Measured: no flip at all in fp32; in bf16, 0–2 flips a test.

Tolerances are ``tests/test_torch_lm.py``'s and ``tests/test_torch_grads.py``'s:
logits within 1e-4 (fp32) and 0.1 (bf16), caches within one bf16 ULP of
their value (fp32) and 0.0625 (bf16), gradients within 1e-4 of the leaf's
largest |g| (fp32) and a relative norm of 0.05 (bf16).  The MoE block alone:
fp32 within 1e-5 of the output's largest |y|; bf16 within 2^-6 of it (one
rounding more or less of a bf16 product, as ``test_mlps``).  The router's
aux: within 1e-6 (fp32, a few ULPs of a sum of E products) and 2e-3
(bf16: the gates' means move by the rounding of the input) of its value,
plus E / (G·T) for each flipped top-1 choice (one token moved between two
experts' counts).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import specs as jspecs
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import registry
from repro_torch.models.api import build_model
from repro_torch.models.blocks import MoE
from repro_torch.models.convert import lm_params_from_jax, tensor_from_numpy, to_tree

from _torch_routing import Routing, _few, _np, flips

torch.set_num_threads(1)

MOE = ["granite_moe_1b_a400m", "olmoe_1b_7b"]
VLM = "qwen2_vl_72b"
FAMILIES = MOE + [VLM]
LOGIT_TOL = {"fp32": 1e-4, "bf16": 0.1}
CACHE_TOL = {"fp32": 0.0, "bf16": 0.0625}  # fp32: one bf16 ULP, relative
AUX_TOL = {"fp32": 1e-6, "bf16": 2e-3}  # relative
S_MAX = 16


def _t(a):
    return tensor_from_numpy(np.asarray(a))


def _aux_close(got, want, prec, cfg, top1, tokens):
    """The aux within ``AUX_TOL`` of its value, plus E / tokens for each of
    ``top1`` flipped top-1 choices."""
    tol = AUX_TOL[prec] * abs(float(want)) + cfg.moe.num_experts * top1 / tokens
    _close(got, want, tol, "aux")
    return tol


def _close(got, want, tol, what, keep=None):
    """max |got − want| ≤ tol over the entries ``keep`` selects (all)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    d = np.abs(got - want)
    if keep is not None:
        d = d[np.broadcast_to(keep, d.shape)]
    diff = float(d.max()) if d.size else 0.0
    assert diff <= tol, f"{what}: max|diff| {diff} > {tol}"


# --------------------------------------------------------------------- #
# the MoE block alone, the same input in both packages
# --------------------------------------------------------------------- #
def _block_pair(name, prec):
    cfg = jreg.get_smoke_config(name)
    p = jblocks.moe_init(jax.random.PRNGKey(3), cfg)
    if prec == "fp32":
        p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    moe = MoE(registry.get_smoke_config(name), torch.Generator().manual_seed(0))
    for leaf, arr in p.items():
        getattr(moe, leaf).data = _t(arr).clone()
    assert {n: q.dtype for n, q in moe.named_parameters()}["router"] == torch.float32
    return cfg, p, moe


def _block_input(cfg, shape, prec, seed, crowd=False):
    """(B, S, D) input; ``crowd`` gives every token nearly the same hidden
    state, so every group routes alike and capacity drops choices."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape + (cfg.d_model,)).astype(np.float32)
    if crowd:
        x = rng.normal(0, 1, (cfg.d_model,)).astype(np.float32) + 0.05 * x
    jx = jnp.asarray(x, jnp.bfloat16 if prec == "bf16" else jnp.float32)
    return jx, _t(jx)


class _OneLayer:
    """A stand-in model of one layer, so ``Routing`` wraps a bare block."""

    def __init__(self, moe):
        self.layers = [type("L", (), {"moe": moe})()]


BLOCK_CASES = {"rows": ((2, 32), False), "decode": ((8, 1), False),
               "drops": ((2, 40), True), "decode-drops": ((8, 1), True)}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("name", MOE)
def test_moe_block_equals_moe_apply(name, prec, case):
    """``MoE.forward`` against ``moe_apply`` on one input: S > 1 (a group a
    row) and S == 1 (the batch one group), with and without capacity
    drops; top-k sets, outputs, aux and the dispatch's drops."""
    cfg, p, moe = _block_pair(name, prec)
    shape, crowd = BLOCK_CASES[case]
    jx, tx = _block_input(cfg, shape, prec, seed=len(case), crowd=crowd)
    with Routing({"layers": {"moe": jax.tree.map(lambda a: a[None], p)}}, _OneLayer(moe)) as rec:
        want, want_aux = jax.jit(lambda p_, x_: jblocks.moe_apply(p_, x_, cfg))(p, jx)
        with torch.no_grad():
            got, got_aux = moe(tx)
        g, t = shape if shape[1] > 1 else (1, shape[0])
        taint = np.zeros((g, t), bool)
        found, n, top1 = flips(rec.take(), cfg.moe.top_k, "same input", taint)
    print(f"{name} {prec} {case}: {len(found)} of {n} tokens excluded (routing gap < 1e-5)")
    _few(len(found), n)
    keep = ~taint.reshape(shape)[..., None]
    assert got.dtype == tx.dtype and got.shape == tx.shape
    scale = float(np.abs(_np(want)).max())
    _close(got, want, (1e-5 if prec == "fp32" else 2.0 ** -6) * scale, "moe output", keep)
    _aux_close(got_aux, want_aux, prec, cfg, top1, g * t)
    # the dispatch: how many choices capacity dropped
    gates, _, topi = moe.route(tx.reshape(g, t, -1))
    _, _, _, kept = moe.dispatch(topi, t)
    dropped = int((~kept).sum())
    if crowd:
        assert dropped > 0, "the crowded input dropped no choice"
    else:
        assert dropped < kept.numel()


def test_dispatch_fills_slots_in_token_major_order():
    """The dispatch on a hand-made routing: choices fill each expert's
    buffer in token-major order, choice j minor; those past ``cap`` are
    dropped to (0, 0) and the scatter-max keeps every kept token's id."""
    cfg = registry.get_smoke_config("granite_moe_1b_a400m")
    moe = MoE(cfg, torch.Generator().manual_seed(0))
    # 6 tokens, k = 2 of 4 experts: cap = min(6, max(4, int(1.25·6·2/4))) = 4
    topi = torch.tensor([[[1, 0], [1, 2], [0, 1], [1, 3], [1, 0], [2, 1]]])
    buf, idx_e, idx_c, keep = moe.dispatch(topi, 6)
    assert buf.shape == (1, 4, 4)
    assert buf[0].tolist() == [[0, 2, 4, -1], [0, 1, 2, 3], [1, 5, -1, -1], [3, -1, -1, -1]]
    assert keep[0].tolist() == [True] * 8 + [False, True, True, False]
    for dropped in (8, 11):  # to (0, 0)
        assert idx_e[0, dropped].item() == 0 and idx_c[0, dropped].item() == 0
    assert idx_e[0, :8].tolist() == [1, 0, 1, 2, 0, 1, 1, 3]
    assert idx_c[0, :8].tolist() == [0, 0, 1, 0, 1, 2, 3, 0]


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("name", MOE)
def test_moe_block_backward_equals_the_reference(name, prec):
    """The block's vjp (input, router and experts, through y and aux) against
    ``jax.vjp`` of ``moe_apply`` on one input and one cotangent, with drops:
    fp32 within 1e-4 of each leaf's largest |g|, bf16 within a relative
    norm of 0.05."""
    cfg, p, moe = _block_pair(name, prec)
    jx, tx = _block_input(cfg, (2, 40), prec, seed=5, crowd=True)
    dy = np.random.default_rng(6).normal(0, 1, jx.shape).astype(np.float32)
    jdy = jnp.asarray(dy, jx.dtype)
    _, vjp = jax.vjp(lambda p_, x_: jblocks.moe_apply(p_, x_, cfg), p, jx)
    want_p, want_x = vjp((jdy, jnp.float32(0.5)))
    params = dict(moe.named_parameters())
    leaves = [tx.requires_grad_(True)] + [q.requires_grad_(True) for q in params.values()]
    y, aux = moe(tx)
    got = torch.autograd.grad([y, aux], leaves, [_t(jdy), torch.tensor(0.5)])
    for what, g, w in [("x", got[0], want_x)] + [
            (n, g, want_p[n]) for n, g in zip(params, got[1:])]:
        g, w = _np(g), _np(w)
        if prec == "fp32":
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), what
        else:
            assert np.linalg.norm(g - w) <= 0.05 * np.linalg.norm(w), what


# --------------------------------------------------------------------- #
# the whole models
# --------------------------------------------------------------------- #
def _params(name, prec, **over):
    jcfg = dataclasses.replace(jreg.get_smoke_config(name), **over)
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    if prec == "fp32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    cfg = dataclasses.replace(registry.get_smoke_config(name), **over)
    tm = lm_params_from_jax(build_model(cfg, device="cpu"), jax.tree.map(np.asarray, params))
    return jcfg, params, tm


@pytest.fixture(scope="module", params=[(n, p) for n in FAMILIES for p in ("fp32", "bf16")],
                ids=lambda np_: f"{np_[0]}-{np_[1]}")
def pair(request):
    name, prec = request.param
    jcfg, params, tm = _params(name, prec)
    return dict(name=name, cfg=jcfg, params=params, tm=tm, prec=prec)


def _batch(cfg, prec, b=2, s=32, seed=1):
    """The reference's ``make_batch`` (vlm: patch embeddings, text tokens,
    ``pos3``), in both packages; ``vis_embeds`` upcast in fp32."""
    jb = dict(jspecs.make_batch(cfg, jcommon.ShapeSpec("t", s, b, "train"), seed=seed))
    if "vis_embeds" in jb and prec == "fp32":
        jb["vis_embeds"] = jb["vis_embeds"].astype(jnp.float32)
    return jb, {k: _t(v) for k, v in jb.items()}


def _logits_ref(pair, jb):
    """The reference's full-sequence logits (its ``loss`` without
    ``_xent``)."""
    jm, p, cfg = jax_build_model(pair["cfg"]), pair["params"], pair["cfg"]
    from repro.models.transformer import _logits

    def run(p_, b_):
        h = jm._embed_inputs(p_, b_)
        pos = jnp.broadcast_to(jnp.arange(h.shape[1], dtype=jnp.int32), h.shape[:2])
        h, _ = jm._run_layers(p_, h, pos, b_.get("pos3") if cfg.mrope else None)
        return _logits(p_, jcommon.rms_norm(h, p_["final_norm"], cfg.norm_eps), cfg)
    return jax.jit(run)(p, jb)


def test_loss_and_logits(pair):
    cfg, tm, prec = pair["cfg"], pair["tm"], pair["prec"]
    jb, tb = _batch(cfg, prec)
    b, s_text = jb["labels"].shape
    ones = np.ones((b, s_text), np.float32)
    jb["loss_mask"], tb["loss_mask"] = jnp.asarray(ones), _t(ones)
    moe = cfg.family == "moe"
    with Routing(pair["params"], tm) as rec:
        jm = jax_build_model(cfg)
        loss_fn = jax.jit(lambda p_, b_: jm.loss(p_, b_))
        want, wm = loss_fn(pair["params"], jb)
        with torch.no_grad():
            got, gm = tm.loss(tb)
        s_vis = 0 if not cfg.frontend else jb["vis_embeds"].shape[1]
        taint = np.zeros((b, s_vis + s_text), bool)
        found, n, top1 = flips(rec.take(), cfg.moe.top_k, prec, taint) if moe else ([], 0, 0)
        keep = ~taint[:, s_vis:]
        print(f"{pair['name']} {prec}: {len(found)} flips of {n} token-layers, "
              f"{int(taint.sum())} of {taint.size} positions tainted")
        _few(len(found), n)
        if found:  # the same programs on a mask without the tainted positions
            jb["loss_mask"], tb["loss_mask"] = jnp.asarray(keep, jnp.float32), _t(keep * 1.0)
            want, wm = loss_fn(pair["params"], jb)
            with torch.no_grad():
                got, gm = tm.loss({**tb, "loss_mask": tb["loss_mask"].float()})
            again = np.zeros_like(taint)
            assert len(flips(rec.take(), cfg.moe.top_k, prec, again)[0]) == len(found)
        # a mean of per-token xent: the logits' bound carries over
        _close(gm["xent"], wm["xent"], LOGIT_TOL[prec] * 0.25, "xent")
        t = b * (s_text + s_vis)
        aux_tol = 0.0
        if moe:
            aux_tol = _aux_close(gm["aux"], wm["aux"], prec, cfg, top1, t)
            assert 0 < float(gm["aux"]) <= cfg.moe.num_experts
        else:
            assert float(gm["aux"]) == float(wm["aux"]) == 0.0
        _close(got, gm["xent"] + 0.01 * gm["aux"], 1e-6, "loss = xent + 0.01 aux")
        _close(got, want, LOGIT_TOL[prec] * 0.25 + 0.01 * aux_tol, "loss")
        # the whole sequence's logits (patch prefix included), another program
        want_logits = _logits_ref(pair, jb)
        with torch.no_grad():
            got_logits = tm(tb["tokens"], tb.get("vis_embeds"), tb.get("pos3"))
        taint = np.zeros(got_logits.shape[:2], bool)
        if moe:
            flips(rec.take(), cfg.moe.top_k, prec, taint)
    _close(got_logits, want_logits, LOGIT_TOL[prec], "logits", ~taint[..., None])


def _cache_close(got, want, prec, what, keep=None):
    got, want = _np(got), _np(want)
    if keep is not None:
        got, want = got[np.broadcast_to(keep, got.shape)], want[np.broadcast_to(keep, want.shape)]
    if prec == "fp32":
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-5, err_msg=what)
    else:
        _close(got, want, CACHE_TOL[prec], what)


def test_prefill_logits_and_cache(pair):
    cfg, tm, prec = pair["cfg"], pair["tm"], pair["prec"]
    jb, tb = _batch(cfg, prec, s=24, seed=4)
    for b in (jb, tb):
        b.pop("labels")
    with Routing(pair["params"], tm) as rec:
        jm = jax_build_model(cfg)
        want, wc = jax.jit(lambda p_, b_: jm.prefill(p_, b_))(pair["params"], jb)
        with torch.no_grad():
            got, gc = tm.prefill(tb)
        taint = np.zeros((2, gc["k"].shape[2]), bool)
        found, n, _ = (flips(rec.take(), cfg.moe.top_k, prec, taint) if cfg.family == "moe"
                       else ([], 0, 0))
    keep = ~taint
    print(f"{pair['name']} {prec}: {len(found)} flips of {n}")
    _few(len(found), n)
    assert got.shape == (2, 1, cfg.vocab) and gc["k"].dtype == torch.bfloat16
    _close(got, want, LOGIT_TOL[prec], "prefill logits", keep[:, -1:, None])
    for key in ("k", "v"):
        _cache_close(gc[key], wc[key], prec, f"prefill cache {key}", keep[None, :, :, None, None])


def _decode_run(pair, pos_of, with_pos3=False):
    """20 decode steps from an empty (2, S_MAX) cache in both packages; the
    logits held every step on the rows no flip has tainted, the caches at
    the end on those rows."""
    cfg, tm, prec = pair["cfg"], pair["tm"], pair["prec"]
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 20)).astype(np.int32)
    pos3 = np.random.default_rng(6).integers(0, 64, (20, 3, 2, 1)).astype(np.int32)
    with Routing(pair["params"], tm) as rec:
        jm = jax_build_model(cfg)
        decode = jax.jit(lambda p_, c_, b_: jm.decode_step(p_, c_, b_))
        jc, tc = jm.init_cache(2, S_MAX), tm.init_cache(2, S_MAX)
        if prec == "fp32":
            jc = jax.tree.map(lambda a: a.astype(jnp.float32), jc)
            tc = {k: v.float() for k, v in tc.items()}
        taint = np.zeros((1, 2), bool)  # one group of the B rows
        n_flips = n_routed = 0
        for t in range(20):
            pos = pos_of(t)
            jb = {"tokens": jnp.asarray(toks[:, t:t + 1]), "pos": jnp.asarray(pos)}
            tb = {"tokens": _t(toks[:, t:t + 1]), "pos": _t(pos)}
            if with_pos3:
                jb["pos3"], tb["pos3"] = jnp.asarray(pos3[t]), _t(pos3[t])
            want, jc = decode(pair["params"], jc, jb)
            with torch.no_grad():
                got, tc = tm.decode_step(tc, tb)
            if cfg.family == "moe":
                # cap = min(B, 4) = B: a flip moves no other row's slot
                found, n, _ = flips(rec.take(), cfg.moe.top_k, prec, taint, spread=False)
                n_flips, n_routed = n_flips + len(found), n_routed + n
            live = ~taint[0]
            _close(got, want, LOGIT_TOL[prec], f"decode logits at pos {pos}", live[:, None, None])
    print(f"{pair['name']} {prec}: {n_flips} flips over 20 steps, rows left {live.sum()}")
    _few(n_flips, n_routed)
    for key in ("k", "v"):
        _cache_close(tc[key], jc[key], prec, f"decode cache {key}", live[None, :, None, None, None])


def test_decode_scalar_pos(pair):
    _decode_run(pair, lambda t: np.int32(t))


def test_decode_vector_pos(pair):
    _decode_run(pair, lambda t: np.array([t, t // 2], np.int32))


def test_decode_with_pos3(pair):
    """``pos3`` rotates q and k by M-RoPE in the vlm family (and is ignored
    by the others, as in the reference)."""
    _decode_run(pair, lambda t: np.array([t, t // 2], np.int32), with_pos3=True)


def test_pos3_moves_the_vlm_decode():
    """The vlm's decode with ``pos3`` differs from the one without (1-D
    RoPE at ``pos``), in both packages alike."""
    jcfg, params, tm = _params(VLM, "fp32")
    jm = jax_build_model(jcfg)
    toks = np.array([[3], [7]], np.int32)
    pos3 = np.array([[[5], [1]], [[2], [9]], [[8], [4]]], np.int32)
    base = {"tokens": toks, "pos": np.array([2, 3], np.int32)}
    outs = []
    for extra in ({}, {"pos3": pos3}):
        b = {**base, **extra}
        want, _ = jm.decode_step(params, jm.init_cache(2, 8), jax.tree.map(jnp.asarray, b))
        got, _ = tm.decode_step(tm.init_cache(2, 8), {k: _t(v) for k, v in b.items()})
        _close(got, want, 1e-4, f"decode {sorted(b)}")
        outs.append(_np(got))
    assert np.abs(outs[0] - outs[1]).max() > 1e-3


# --------------------------------------------------------------------- #
# gradients and remat
# --------------------------------------------------------------------- #
def _leaves(tree, want):
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = tree
        for k in path:
            node = node[k.key]
        yield jax.tree_util.keystr(path), _np(node), _np(w)


def _port_grads(model, tb):
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss, metrics = model.loss(tb)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), to_tree(dict(zip(params, grads)))


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_gradients_equal_the_reference(name, prec):
    """Every leaf's gradient against ``jax.value_and_grad`` of the
    reference's ``loss`` (the router's and the experts' included, the aux
    term too): fp32 within 1e-4 of the leaf's largest |g|, bf16 within a
    relative norm of 0.05, on a loss mask that leaves out what a flip
    tainted (none in fp32)."""
    jcfg, params, tm = _params(name, prec)
    jb, tb = _batch(jcfg, prec)
    b, s_text = jb["labels"].shape
    mask = np.ones((b, s_text), np.float32)
    with Routing(params, tm) as rec:
        jm = jax_build_model(jcfg)
        vg = jax.jit(jax.value_and_grad(lambda p_, b_: jm.loss(p_, b_), has_aux=True))
        found = []
        for attempt in range(2):
            jb["loss_mask"], tb["loss_mask"] = jnp.asarray(mask), _t(mask)
            (want_loss, _), want = vg(params, jb)
            loss, got = _port_grads(tm, tb)
            if jcfg.family != "moe":
                break
            taint = np.zeros((b, s_text), bool)  # the moe family has no patch prefix
            found, n, _ = flips(rec.take(), jcfg.moe.top_k, prec, taint)
            if not found or attempt:
                break
            mask = (~taint).astype(np.float32)
    if prec == "fp32":
        assert not found
    print(f"{name} {prec}: {len(found)} flips, {int((mask == 0).sum())} positions masked")
    if found:
        _few(len(found), n)
    assert abs(loss - float(want_loss)) <= (1e-5 if prec == "fp32" else 0.02)
    for path, g, w in _leaves(got, want):
        assert g.shape == w.shape, path
        if prec == "fp32":
            err = np.abs(g - w).max()
            assert err <= 1e-4 * np.abs(w).max(), (path, err, np.abs(w).max())
        else:
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert rel <= 0.05, (path, rel)


@pytest.mark.parametrize("name", FAMILIES)
def test_remat_changes_no_gradient(name):
    """``remat="full"`` against ``"none"``: the loss and every gradient bit
    for bit (the backward recomputes each layer, the MoE's routing and
    dispatch included, with the same ops)."""
    runs = []
    for remat in ("full", "none"):
        jcfg, _, tm = _params(name, "bf16", remat=remat)
        calls = []
        forward = tm.layers[0].forward
        tm.layers[0].forward = lambda *a: calls.append(1) or forward(*a)
        _, tb = _batch(jcfg, "bf16", seed=2)
        runs.append((_port_grads(tm, tb), len(calls)))
    (loss_full, g_full), n_full = runs[0]
    (loss_none, g_none), n_none = runs[1]
    assert (n_full, n_none) == (2, 1)  # the backward ran layer 0 again
    assert loss_full == loss_none
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(g_full)[0],
                                 jax.tree_util.tree_flatten_with_path(g_none)[0]):
        assert torch.equal(a, b), path
