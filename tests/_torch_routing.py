"""Routing records of the MoE layers in both packages, for the parity tests
of the port's ``moe`` family (``tests/test_torch_moe.py``,
``tests/test_torch_moe_training.py``, whose docstring says how they are
used): ``Routing`` captures the fp32 gates of every MoE call, ``flips``
compares the top-k choices of the two packages and marks what a flip
reaches."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import blocks as jblocks

# the reference's gap between the k-th and (k+1)-th gate below which a
# choice may differ: the same input in both packages, fp32 models, bf16 models
FLIP_GAP = {"same input": 1e-5, "fp32": 1e-5, "bf16": 1e-2}
MAX_FLIP_SHARE = 0.05  # of the token-layers a test routes


def _np(t):
    """numpy fp32 of a jax array or a torch tensor."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _topk_sets(gates, k):
    """Top-k experts of fp32 ``gates`` ``(..., E)``, ties to the lower
    index (``jax.lax.top_k``'s and the port's stable sort), as sorted sets;
    and the gap between the k-th and (k+1)-th gate."""
    order = np.argsort(-gates, axis=-1, kind="stable")
    s = np.take_along_axis(gates, order, -1)
    gap = s[..., k - 1] - s[..., k] if gates.shape[-1] > k else np.full(gates.shape[:-1], np.inf)
    return np.sort(order[..., :k], -1), gap


class Routing:
    """Records the gates of every MoE call in both packages.

    The reference's ``moe_apply`` calls ``_moe_grouped`` through its
    module, so a wrapper installed there while a function is traced sends
    each call's fp32 gates (and the router's first column, which names the
    layer) to the host by ``jax.debug.callback``; XLA computes them once
    with the routing they shadow.  Trace the reference's functions inside
    ``with Routing(...)`` on a fresh model object, so nothing traced before
    is reused.  The port's layers' ``MoE.route`` are wrapped the same way.
    ``take()`` returns and clears both records since the last call."""

    def __init__(self, params, model):
        self.model = model
        self.cols = (None if "layers" not in params or "moe" not in params["layers"]
                     else np.asarray(params["layers"]["moe"]["router"], np.float32)[:, :, 0])
        self.ref, self.port = [], []

    def __enter__(self):
        orig = self.orig = jblocks._moe_grouped

        def wrapped(p, x, cfg):
            gates = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
            jax.debug.callback(lambda col, g: self.ref.append((np.asarray(col, np.float32),
                                                               np.asarray(g))),
                               p["router"][:, 0], gates)
            return orig(p, x, cfg)

        jblocks._moe_grouped = wrapped
        for l, layer in enumerate(self.model.layers):
            if hasattr(layer, "moe"):
                route = layer.moe.route

                def recorded(x, route=route, l=l):
                    out = route(x)
                    self.port.append((l, _np(out[0])))
                    return out
                layer.moe.route = recorded
        return self

    def __exit__(self, *exc):
        jblocks._moe_grouped = self.orig
        for layer in self.model.layers:
            if hasattr(layer, "moe"):
                layer.moe.__dict__.pop("route", None)

    def take(self):
        jax.effects_barrier()
        ref, port = self.ref, self.port
        self.ref, self.port = [], []
        ref = [(int(np.argmin(np.abs(self.cols - col).max(-1))), g) for col, g in ref]
        return ref, port


def flips(records, k, prec, taint, spread=True, rows=lambda i: slice(None)):
    """Compare the routing of ``records`` (``Routing.take()``) layer by
    layer: every reference call is matched to the port's call of its layer
    with the nearest gates (calls may repeat, under remat, and come in any
    order).  ``taint`` ``(G, T)`` marks the tokens a flip has reached; on
    the others the top-k sets must be equal wherever the reference's gap is
    at least ``FLIP_GAP[prec]``.  Each layer's flips then taint their token
    (``spread``: and the rest of its group, whose capacity slots it moves)
    for the layers after it; ``taint`` is updated in place (``rows(i)``:
    the rows of ``taint`` the port's i-th call routed, where calls take
    parts of a batch).  Returns the
    flips as (layer, group, token, reference gap), the token-layers
    compared and the untainted tokens whose top-1 expert differs (the aux
    counts it; allowed, with the set kept, where the reference's first two
    gates are within ``FLIP_GAP``)."""
    ref, port = records
    assert len(ref) > 0 and len(port) > 0, "no MoE call recorded"
    out, seen, n, top1 = [], set(), 0, 0
    for l, rg in sorted(ref, key=lambda r: r[0]):
        cands = [(i, pg) for i, (pl, pg) in enumerate(port) if pl == l and pg.shape == rg.shape]
        assert cands, f"no port call of layer {l} with gates {rg.shape}"
        i, pg = min(cands, key=lambda c: float(np.abs(c[1] - rg).max()))
        if i in seen:
            continue
        seen.add(i)
        want, gap = _topk_sets(rg, k)
        got, _ = _topk_sets(pg, k)
        part = taint[rows(i)]  # a view: the rows this call routed
        differ = (want != got).any(-1) & ~part
        n += int((~part).sum())
        bad = differ & (gap >= FLIP_GAP[prec])
        assert not bad.any(), (f"layer {l}: top-{k} sets differ at {np.argwhere(bad)[:4]} "
                               f"with gaps {gap[bad][:4]} >= {FLIP_GAP[prec]}")
        first = (np.argmax(rg, -1) != np.argmax(pg, -1)) & ~part
        top2 = np.sort(rg, -1)[..., -2:]
        assert (top2[..., 1] - top2[..., 0] < FLIP_GAP[prec])[first].all(), f"layer {l}: top-1"
        top1 += int(first.sum())
        for g, t in np.argwhere(differ):
            out.append((l, int(g), int(t), float(gap[g, t])))
            if spread:
                part[g, t:] = True
            else:
                part[g, t] = True
    return out, n, top1


def _few(n_flips, n):
    """A test's flips stay a small share of its token-layers."""
    assert n_flips <= MAX_FLIP_SHARE * max(n, 1), f"{n_flips} flips in {n} token-layers"
