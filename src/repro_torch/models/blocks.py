"""Layer blocks: GQA attention, the dense MLP (SwiGLU or GELU), the
token-choice MoE, Mamba2 and xLSTM's mLSTM and sLSTM.

Counterpart of the attention, MLP, MoE, Mamba2 and xLSTM part of
``repro.models.blocks``.
The reference's ``<block>_init`` / ``<block>_apply`` pairs over dicts of
arrays become ``nn.Module``s holding ``nn.Parameter``s under the reference's
leaf names (``wq``, ``wk``, ``wv``, ``wo``, ``q_norm``, ``k_norm``, ``w1``,
``w3``, ``w2``, ``router`` …, weights laid out ``(in, out)`` as there), each
with a ``forward`` for a whole sequence and, for attention, a ``decode``
against a KV cache (and a ``cross_attn`` over an encoder's output), or,
for the recurrent blocks, a ``forward`` that takes and returns their state
(and, for Mamba2 and the mLSTM, a ``decode`` of one token).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import (
    MASKED,
    ArchConfig,
    attention,
    dense_init,
    gelu_mlp,
    mm,
    mrope,
    rms_norm,
    rope,
    swiglu,
)
from repro_torch.models.ssd import (
    NEG_INF,
    mlstm_chunked,
    mlstm_decode_step,
    ssd_chunked,
    ssd_decode_step,
)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _zeros(n: int, gen: torch.Generator) -> nn.Parameter:
    return _param(torch.zeros(n, dtype=torch.bfloat16, device=gen.device))


def _ones(n: int, gen: torch.Generator) -> nn.Parameter:
    return _param(torch.ones(n, dtype=torch.bfloat16, device=gen.device))


# --------------------------------------------------------------------- #
# Attention
# --------------------------------------------------------------------- #
class Attention(nn.Module):
    """GQA attention (``attn_init``, ``attn_apply``, ``attn_decode``): causal
    or bidirectional, with RoPE (M-RoPE under ``cfg.mrope`` when the caller
    gives ``pos3``; none when ``positions`` is None), optional qk-norm and,
    with ``bias``, the biases ``bq``, ``bk``, ``bv``, ``bo`` (bf16 zeros,
    added after each product).  ``cross_attn`` and ``memory_kv`` are the
    reference's ``cross_attn_apply`` and ``memory_kv_init``: the decoder's
    queries against k and v projected from the encoder's output."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator, bias: bool = False):
        super().__init__()
        self.cfg = cfg
        d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.wq = _param(dense_init(gen, (d, h * hd)))
        self.wk = _param(dense_init(gen, (d, hkv * hd)))
        self.wv = _param(dense_init(gen, (d, hkv * hd)))
        self.wo = _param(dense_init(gen, (h * hd, d), scale=1.0 / math.sqrt(h * hd)))
        for name, n in (("bq", h * hd), ("bk", hkv * hd), ("bv", hkv * hd), ("bo", d)):
            self.register_parameter(name, _zeros(n, gen) if bias else None)
        if cfg.qk_norm:
            self.q_norm, self.k_norm = _ones(hd, gen), _ones(hd, gen)

    @staticmethod
    def _proj(x, w, b):
        """``x @ w`` plus the bias ``b`` unless it is None (the reference's
        ``x @ w + p.get(b, 0)``)."""
        y = mm(x, w)
        return y if b is None else y + b

    def _project_qkv(self, x):
        cfg = self.cfg
        b, s, _ = x.shape
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q = self._proj(x, self.wq, self.bq).reshape(b, s, h, hd)
        k, v = self.memory_kv(x)
        if cfg.qk_norm:
            q = rms_norm(q, self.q_norm, cfg.norm_eps)
            k = rms_norm(k, self.k_norm, cfg.norm_eps)
        return q, k, v

    def _apply_rope(self, q, k, positions, pos3):
        """The reference's ``_apply_rope``: M-RoPE by the ``(3, B, S)``
        ``pos3`` under ``cfg.mrope`` when it is given, else 1-D RoPE, or no
        rotation when ``positions`` is None."""
        theta = self.cfg.rope_theta
        if self.cfg.mrope and pos3 is not None:
            return mrope(q, pos3, theta), mrope(k, pos3, theta)
        if positions is None:
            return q, k
        return rope(q, positions, theta), rope(k, positions, theta)

    def _out(self, y):
        """The heads ``(B, S, H, hd)`` through ``wo`` (and ``bo``)."""
        b, s = y.shape[:2]
        return self._proj(y.reshape(b, s, self.cfg.n_heads * self.cfg.hd), self.wo, self.bo)

    def forward(self, x, positions, pos3=None, causal=True):
        """Full-sequence attention (train / prefill), causal or, with
        ``causal=False``, bidirectional.  Returns (y, (k, v))."""
        cfg = self.cfg
        q, k, v = self._project_qkv(x)
        q, k = self._apply_rope(q, k, positions, pos3)
        y = attention(q, k, v, causal=causal, window=cfg.sliding_window,
                      impl=cfg.attn_impl, q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk)
        return self._out(y), (k, v)

    def cross_attn(self, x, memory_kv):
        """``cross_attn_apply``: bidirectional attention of ``x``'s queries
        (no RoPE, no qk-norm) over ``memory_kv`` = (k, v) ``(B, S_mem, Hkv,
        hd)``, projected from the encoder's output by ``memory_kv``."""
        cfg = self.cfg
        b, s, _ = x.shape
        q = self._proj(x, self.wq, self.bq).reshape(b, s, cfg.n_heads, cfg.hd)
        k, v = memory_kv
        y = attention(q, k, v, causal=False, impl=cfg.attn_impl, q_chunk=cfg.q_chunk,
                      k_chunk=cfg.k_chunk)
        return self._out(y)

    def memory_kv(self, memory):
        """``memory_kv_init``: (k, v) ``(B, S, Hkv, hd)`` of ``memory``."""
        b, s, _ = memory.shape
        hkv, hd = self.cfg.n_kv_heads, self.cfg.hd
        return (self._proj(memory, self.wk, self.bk).reshape(b, s, hkv, hd),
                self._proj(memory, self.wv, self.bv).reshape(b, s, hkv, hd))

    def decode(self, x, k_cache, v_cache, pos, pos3=None):
        """One-token decode against a KV cache, written IN PLACE.

        ``k_cache``/``v_cache``: ``(B, S, Hkv, hd)``; this step's k and v
        are written into them (the caller passes the step's own copy of the
        cache: ``TransformerLM.decode_step`` clones it once a step, so its
        input cache is left as it was, as the reference's functional update
        leaves it).  ``pos`` is the write index: a scalar (a uniform decode
        wave) or a ``(B,)`` vector (continuous batching: every slot at its
        own position); ``pos3`` (``(3, B, 1)``, optional) rotates q and k by
        M-RoPE in its place.  Sliding-window layers treat the cache as a ring
        buffer.  A write at or past the cache's end is DROPPED, as the
        reference's out-of-range scatter is (torch indexing would raise):
        the row keeps its old value and attends over the cache without the
        new token.  Returns y ``(B, 1, D)``.
        """
        cfg = self.cfg
        b = x.shape[0]
        q, k, v = self._project_qkv(x)  # s == 1
        pos_b = torch.as_tensor(pos, device=x.device).to(torch.int64).broadcast_to((b,))
        q, k = self._apply_rope(q, k, pos_b[:, None], pos3)
        s_max = k_cache.shape[1]
        write = pos_b % s_max if cfg.sliding_window else pos_b
        keep = write < s_max
        at = torch.where(keep, write, 0)
        rows = torch.arange(b, device=x.device)
        for cache, new in ((k_cache, k), (v_cache, v)):
            cache[rows, at] = torch.where(keep[:, None, None], new[:, 0].to(cache.dtype),
                                          cache[rows, at])
        # mask out slots beyond each row's position
        kpos = torch.arange(s_max, device=x.device)
        if cfg.sliding_window:
            valid = (kpos[None, :] <= write[:, None]) | (pos_b >= s_max)[:, None]
        else:
            valid = kpos[None, :] <= pos_b[:, None]
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        qg = q.reshape(b, hkv, h // hkv, hd)
        scores = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float())
        scores = scores * (1.0 / math.sqrt(hd))
        scores = torch.where(valid[:, None, None], scores, MASKED)
        probs = torch.softmax(scores, dim=-1)
        y = torch.einsum("bhgk,bkhd->bhgd", probs.to(v_cache.dtype), v_cache)
        return self._out(y.reshape(b, 1, h, hd))


# --------------------------------------------------------------------- #
# Dense MLP (SwiGLU / GELU)
# --------------------------------------------------------------------- #
class MLP(nn.Module):
    """SwiGLU (``w1``, ``w3``, ``w2``) or, with ``gelu``, a GELU MLP with
    biases (``w1``, ``b1``, ``w2``, ``b2``) — ``mlp_init``."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator, gelu: bool = False):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.gelu = gelu
        self.w1 = _param(dense_init(gen, (d, f)))
        if gelu:
            self.b1 = _zeros(f, gen)
            self.w2 = _param(dense_init(gen, (f, d)))
            self.b2 = _zeros(d, gen)
        else:
            self.w3 = _param(dense_init(gen, (d, f)))
            self.w2 = _param(dense_init(gen, (f, d)))

    def forward(self, x):
        if self.gelu:
            return gelu_mlp(x, self.w1, self.b1, self.w2, self.b2)
        return swiglu(x, self.w1, self.w3, self.w2)


# --------------------------------------------------------------------- #
# Mixture of Experts (token-choice top-k, scatter dispatch)
# --------------------------------------------------------------------- #
class MoE(nn.Module):
    """Token-choice top-k MoE with row-local capacity (``moe_init``,
    ``moe_apply``): an fp32 ``router`` ``(D, E)`` and bf16 SwiGLU experts
    ``w1``/``w3`` ``(E, D, F)``, ``w2`` ``(E, F, D)``.

    Each group of tokens (a batch row; at decode, S == 1, the whole batch
    as one group) dispatches its own top-k choices into per-expert buffers
    of ``cap = min(T, max(4, int(capacity_factor·T·k/E)))`` slots, in
    token-major order with the choice index minor; choices past ``cap``
    are dropped and fall through the caller's residual.  The dispatch moves
    token ids only, the groups batched as tensor ops (the reference
    ``vmap``s them).  Every op is deterministic on the card too, backward
    included: the buffer is filled by an integer scatter-max, and the
    gathers are advanced indexing, whose backward accumulates in sorted
    order (``torch.gather``'s would use atomics)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        assert cfg.moe is not None
        self.cfg = cfg
        d, e, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_expert
        self.router = _param(dense_init(gen, (d, e), dtype=torch.float32))
        self.w1 = _param(dense_init(gen, (e, d, f)))
        self.w3 = _param(dense_init(gen, (e, d, f)))
        self.w2 = _param(dense_init(gen, (e, f, d)))

    def forward(self, x):
        """(y, aux) of ``x`` ``(B, S, D)``: y in ``x``'s dtype, aux the
        Switch-style load-balance loss (an fp32 scalar)."""
        b, s, d = x.shape
        if s == 1:  # decode: one group of B tokens
            y, aux = self.grouped(x.reshape(1, b, d))
            return y.reshape(b, s, d), aux
        return self.grouped(x)

    def route(self, x):
        """The router on ``x`` ``(G, T, D)``: (gates ``(G, T, E)`` fp32, the
        top-k gates renormalized and their experts ``(G, T, k)``), ties to
        the lower expert as ``jax.lax.top_k`` breaks them."""
        k = self.cfg.moe.top_k
        gates = torch.softmax(mm(x.float(), self.router), dim=-1)
        topw, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
        topw, topi = topw[..., :k], topi[..., :k]
        return gates, topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9), topi

    def dispatch(self, topi, t: int):
        """Index-only dispatch of the ``(G, T, k)`` choices: (``buf_idx``
        ``(G, E, cap)`` token ids, -1 for an empty slot; each choice's
        expert and slot, ``(0, 0)`` where dropped; the kept mask)."""
        g, e, k = topi.shape[0], self.cfg.moe.num_experts, self.cfg.moe.top_k
        cap = min(t, max(4, int(self.cfg.moe.capacity_factor * t * k / e)))
        flat_e = topi.reshape(g, t * k)
        oh = _one_hot(flat_e, e, torch.int64)
        my_pos = torch.gather(torch.cumsum(oh, dim=1) - oh, 2, flat_e[..., None])[..., 0]
        keep = my_pos < cap
        idx_e = torch.where(keep, flat_e, 0)
        idx_c = torch.where(keep, my_pos, 0)
        tok = torch.where(keep, torch.arange(t * k, device=topi.device) // k, -1)
        # the kept slots are unique; every dropped choice lands on (0, 0) with
        # id -1, which the max never writes over a kept token
        buf_idx = torch.full((g, e * cap), -1, dtype=torch.int64, device=topi.device)
        buf_idx.scatter_reduce_(1, idx_e * cap + idx_c, tok, "amax")
        return buf_idx.reshape(g, e, cap), idx_e, idx_c, keep

    def experts(self, x, buf_idx):
        """The experts on their buffers: ``(G, E, cap, D)`` outputs."""
        rows = torch.arange(x.shape[0], device=x.device)[:, None, None]
        xe = x[rows, torch.clamp(buf_idx, min=0)] * (buf_idx >= 0)[..., None].to(x.dtype)
        h = F.silu(_expert_mm(xe, self.w1)) * _expert_mm(xe, self.w3)
        return _expert_mm(h, self.w2)

    def grouped(self, x):
        """``_moe_grouped``: (y ``(G, T, D)``, aux) of ``x`` ``(G, T, D)``."""
        g, t, d = x.shape
        e, k = self.cfg.moe.num_experts, self.cfg.moe.top_k
        gates, topw, topi = self.route(x)
        buf_idx, idx_e, idx_c, keep = self.dispatch(topi, t)
        ye = self.experts(x, buf_idx)
        # combine: the k choices summed in fp32, in the reference's order
        # (its sum starts from zeros: 0 + c0 is c0's bits)
        rows = torch.arange(g, device=x.device)[:, None, None]
        w = (topw * keep.reshape(g, t, k)).float()
        parts = ye[rows, idx_e.reshape(g, t, k), idx_c.reshape(g, t, k)].float() * w[..., None]
        y = parts[:, :, 0]
        for j in range(1, k):
            y = y + parts[:, :, j]
        # auxiliary load-balance loss (Switch-style)
        me = gates.mean(dim=(0, 1))
        ce = _one_hot(topi[..., 0], e, torch.float32).mean(dim=(0, 1))
        return y.to(ye.dtype), e * torch.sum(me * ce)


def _one_hot(idx, n: int, dtype):
    """``F.one_hot`` without its range checks, which read the indices back
    to the host (two syncs a call on the card)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _expert_mm(a, w):
    """``(G, E, C, I) @ (E, I, O)`` per expert, with jnp's dtype promotion:
    one batched product over E (``torch.matmul`` would copy the weights
    for every group)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return torch.einsum("geci,eio->geco", a.to(dt), w.to(dt))


# --------------------------------------------------------------------- #
# the causal conv (Mamba2 and the mLSTM), Mamba2
# --------------------------------------------------------------------- #
def _causal_conv(x, w, b, hist=None):
    """Depthwise causal conv; x ``(B, S, C)``, w ``(W, C)``; ``hist``
    ``(B, W-1, C)`` carries the previous tokens' tail across prefill and
    decode (zeros when None).  The taps are summed in ``x``'s dtype from 0,
    as the reference's Python ``sum``.  Returns (y ``(B, S, C)``, the new
    tail ``(B, W-1, C)``)."""
    wsz, s = w.shape[0], x.shape[1]
    if hist is None:
        ext = F.pad(x, (0, 0, wsz - 1, 0))
    else:
        ext = torch.cat([hist.to(x.dtype), x], dim=1)
    out = sum(ext[:, i:i + s, :] * w[i][None, None, :] for i in range(wsz))
    return out + b, ext[:, -(wsz - 1):, :]


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


class Mamba2(nn.Module):
    """Mamba2 (``mamba_init``/``mamba_apply``/``mamba_decode``): the input
    projections ``wz``, ``wx``, ``wbc`` (B and C, shared across heads) and
    ``wdt``; a depthwise causal conv on x (``conv_x``, ``conv_x_b``) and on
    B, C (``conv_bc``, ``conv_bc_b``), each with its own tail; the fp32
    ``a_log`` (A = -exp(a_log)), ``d_skip`` and ``dt_bias``; the SSD core;
    a gated RMS ``norm`` and ``out_proj``.  Its state is (the x tail, the
    B/C tail, both bf16; the SSM state ``(B, H, N, P)``, fp32)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        d_in, h, n, _, cw = self.dims()
        self.wz = _param(dense_init(gen, (d, d_in)))
        self.wx = _param(dense_init(gen, (d, d_in)))
        self.wbc = _param(dense_init(gen, (d, 2 * n)))
        self.wdt = _param(dense_init(gen, (d, h)))
        self.conv_x = _param(dense_init(gen, (cw, d_in), scale=1.0 / math.sqrt(cw)))
        self.conv_x_b = _zeros(d_in, gen)
        self.conv_bc = _param(dense_init(gen, (cw, 2 * n), scale=1.0 / math.sqrt(cw)))
        self.conv_bc_b = _zeros(2 * n, gen)
        f32 = dict(dtype=torch.float32, device=gen.device)
        self.a_log = _param(torch.zeros(h, **f32))  # A = -exp(a_log) = -1
        self.d_skip = _param(torch.ones(h, **f32))
        self.dt_bias = _param(torch.zeros(h, **f32))
        self.norm = _ones(d_in, gen)
        self.out_proj = _param(dense_init(gen, (d_in, d)))

    def dims(self):
        """(d_in, heads, d_state, head dim, conv width): ``_mamba_dims``."""
        ssm = self.cfg.ssm
        d_in = ssm.expand * self.cfg.d_model
        return d_in, d_in // ssm.head_dim, ssm.d_state, ssm.head_dim, ssm.conv_width

    def _inputs(self, x, dt, dtype):
        """(la, v): the log decay ``-exp(a_log)·dt`` and the dt-scaled
        inputs in ``dtype``, from ``dt = softplus(u·wdt + dt_bias)`` in
        fp32."""
        dt = _softplus(dt.float() + self.dt_bias)
        v = (x.reshape(*dt.shape, -1).float() * dt[..., None]).to(dtype)
        return -torch.exp(self.a_log) * dt, v

    def _out(self, y, x, z, u):
        """The skip ``d_skip·x``, the gated norm and ``out_proj``."""
        y = y + self.d_skip[:, None] * x.reshape(y.shape)
        y = rms_norm(y.reshape(*u.shape[:-1], -1), self.norm, self.cfg.norm_eps) * F.silu(z)
        return mm(y, self.out_proj).to(u.dtype)

    def forward(self, u, state=None):
        """The whole sequence ``u`` ``(B, S, D)`` through the chunked core
        from ``state`` (None: zeros); returns (y, (x tail, B/C tail, SSM
        state))."""
        n = self.cfg.ssm.d_state
        z, x_raw, bc_raw, dt = (mm(u, w) for w in (self.wz, self.wx, self.wbc, self.wdt))
        x_c, tail_x = _causal_conv(x_raw, self.conv_x, self.conv_x_b,
                                   hist=None if state is None else state[0])
        bc_c, tail_bc = _causal_conv(bc_raw, self.conv_bc, self.conv_bc_b,
                                     hist=None if state is None else state[1])
        x, bc = F.silu(x_c), F.silu(bc_c)
        la, v = self._inputs(x, dt, u.dtype)
        y, ssm = ssd_chunked(la, bc[..., n:], bc[..., :n], v,
                             s0=None if state is None else state[2], chunk=self.cfg.ssm.chunk)
        return self._out(y, x, z, u), (tail_x.to(torch.bfloat16), tail_bc.to(torch.bfloat16), ssm)

    def decode(self, u, state):
        """One token ``u`` ``(B, 1, D)`` through the one-step recurrence
        (``mamba_decode``: the conv as a product over the window, which
        rounds otherwise than ``_causal_conv`` in bf16); returns (y, the new
        state)."""
        n = self.cfg.ssm.d_state
        tail_x, tail_bc, ssm = state
        z, x_raw, bc_raw, dt = (mm(u, w) for w in (self.wz, self.wx, self.wbc, self.wdt))
        win_x = torch.cat([tail_x.to(x_raw.dtype), x_raw], dim=1)  # (B, cw, C)
        win_bc = torch.cat([tail_bc.to(bc_raw.dtype), bc_raw], dim=1)
        x = F.silu(torch.einsum("bwc,wc->bc", win_x, self.conv_x) + self.conv_x_b)
        bc = F.silu(torch.einsum("bwc,wc->bc", win_bc, self.conv_bc) + self.conv_bc_b)
        la, v = self._inputs(x, dt[:, 0], u.dtype)
        y, ssm = ssd_decode_step(la, bc[..., n:], bc[..., :n], v, ssm)
        return self._out(y, x, z, u), (win_x[:, 1:].to(torch.bfloat16),
                                       win_bc[:, 1:].to(torch.bfloat16), ssm)


# --------------------------------------------------------------------- #
# xLSTM: mLSTM and sLSTM
# --------------------------------------------------------------------- #
class MLSTM(nn.Module):
    """xLSTM's matrix-memory block (``mlstm_init``/``mlstm_apply``/
    ``mlstm_decode``): up-projections ``wx_up`` and ``wz_up``, a causal conv
    (``conv_w``, ``conv_b``) before q and k, per-head exponential input and
    sigmoid forget gates from the fp32 ``wif``/``b_if``, the chunked core,
    a ``norm`` and the ``silu(z)`` gate, then ``down_proj``.  Its state is
    (the conv tail, bf16; ``(S̃, ñ, m)``, fp32)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        d_in, h, _, cw = self.dims()
        self.wx_up = _param(dense_init(gen, (d, d_in)))
        self.wz_up = _param(dense_init(gen, (d, d_in)))
        self.conv_w = _param(dense_init(gen, (cw, d_in), scale=1.0 / math.sqrt(cw)))
        self.conv_b = _zeros(d_in, gen)
        self.wq = _param(dense_init(gen, (d_in, d_in)))
        self.wk = _param(dense_init(gen, (d_in, d_in)))
        self.wv = _param(dense_init(gen, (d_in, d_in)))
        self.wif = _param(dense_init(gen, (d_in, 2 * h), dtype=torch.float32))
        self.b_if = _param(torch.cat([torch.zeros(h, device=gen.device),
                                      torch.full((h,), 3.0, device=gen.device)]))
        self.norm = _ones(d_in, gen)
        self.down_proj = _param(dense_init(gen, (d_in, d)))

    def dims(self):
        """(d_in, heads, head dim, conv width): ``_mlstm_dims``."""
        cfg = self.cfg
        d_in = int(cfg.d_model * cfg.xlstm.proj_factor)
        return d_in, cfg.n_heads, d_in // cfg.n_heads, cfg.xlstm.conv_width

    def _gates(self, xc, b, s, h):
        """(li, lf) ``(B, S, H)``: fp32 log input and log forget gates."""
        gif = mm(xc.float(), self.wif) + self.b_if
        return gif[..., :h].reshape(b, s, h), F.logsigmoid(gif[..., h:]).reshape(b, s, h)

    def _out(self, y, z, u):
        y = rms_norm(y, self.norm, self.cfg.norm_eps) * F.silu(z)
        return mm(y, self.down_proj).to(u.dtype)

    def forward(self, u, state=None):
        """The whole sequence ``u`` ``(B, S, D)`` through the chunked core
        from ``state`` (None: zeros); returns (y, the new state)."""
        b, s, _ = u.shape
        d_in, h, hd, _ = self.dims()
        x_in, z = mm(u, self.wx_up), mm(u, self.wz_up)
        conv_out, conv_tail = _causal_conv(x_in, self.conv_w, self.conv_b,
                                           hist=None if state is None else state[0])
        xc = F.silu(conv_out)
        q = mm(xc, self.wq).reshape(b, s, h, hd)
        k = mm(xc, self.wk).reshape(b, s, h, hd)
        v = mm(x_in, self.wv).reshape(b, s, h, hd)
        li, lf = self._gates(xc, b, s, h)
        y, mstate = mlstm_chunked(lf, li, q, k, v, state=None if state is None else state[1],
                                  chunk=self.cfg.xlstm.chunk)
        return self._out(y.reshape(b, s, d_in), z, u), (conv_tail.to(torch.bfloat16), mstate)

    def decode(self, u, state):
        """One token ``u`` ``(B, 1, D)`` through the step-by-step recurrence
        (``mlstm_decode``); returns (y, the new state)."""
        b = u.shape[0]
        d_in, h, hd, _ = self.dims()
        conv_tail, mstate = state
        x_in, z = mm(u, self.wx_up), mm(u, self.wz_up)
        window = torch.cat([conv_tail.to(x_in.dtype), x_in], dim=1)  # (B, cw, C)
        xc = F.silu(torch.einsum("bwc,wc->bc", window, self.conv_w) + self.conv_b)
        q = mm(xc, self.wq).reshape(b, h, hd)
        k = mm(xc, self.wk).reshape(b, h, hd)
        v = mm(x_in[:, 0], self.wv).reshape(b, h, hd)
        li, lf = self._gates(xc[:, None, :], b, 1, h)
        y, mstate = mlstm_decode_step(lf[:, 0], li[:, 0], q, k, v, mstate)
        return self._out(y.reshape(b, 1, d_in), z, u), (window[:, 1:].to(torch.bfloat16), mstate)


class SLSTM(nn.Module):
    """xLSTM's scalar-memory block (``slstm_init``/``slstm_apply``): the
    input projection ``w_in`` plus the fp32 bias ``b`` (rounded to the
    input's dtype before the add), a per-head recurrent ``r``, a sequential
    exponential-gated cell in fp32, ``norm`` and a GELU feed-forward
    (``w_ff1``, ``w_ff2``).  Its state is (h, c, n ``(B, H, hd)``, m
    ``(B, H)``), fp32.  The reference remats each 64-step time chunk of its
    scan, which only saves memory; here the steps are a Python loop."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d_model, cfg.n_heads
        hd, ff = d // h, int(d * 4 / 3)
        self.w_in = _param(dense_init(gen, (d, 4 * d)))
        self.r = _param(dense_init(gen, (h, hd, 4 * hd), scale=1.0 / math.sqrt(hd)))
        self.b = _param(torch.zeros(4 * d, device=gen.device))
        self.norm = _ones(d, gen)
        self.w_ff1 = _param(dense_init(gen, (d, ff)))
        self.w_ff2 = _param(dense_init(gen, (ff, d)))

    def cell(self, wx_t, state):
        """``_slstm_cell``: one step from ``wx_t`` ``(B, 4D)``."""
        h_ = self.cfg.n_heads
        hprev, c, n, m = state
        rec = torch.einsum("bhd,hdk->bhk", hprev.float(), self.r.float())
        gates = wx_t.float().reshape(-1, h_, self.r.shape[-1]) + rec  # (B, H, 4hd)
        zi, ii, fi, oi = torch.chunk(gates, 4, dim=-1)
        # per-head scalar gates
        it, ft = ii.mean(-1), fi.mean(-1)
        m_new = torch.maximum(ft + m, it)
        i_g = torch.exp(it - m_new)[..., None]
        f_g = torch.exp(ft + m - m_new)[..., None]
        c_new = f_g * c + i_g * torch.tanh(zi)
        n_new = f_g * n + i_g
        h_new = torch.sigmoid(oi) * c_new / torch.clamp(n_new, min=1e-6)
        return h_new, c_new, n_new, m_new

    def forward(self, u, state=None):
        """The sequence ``u`` ``(B, S, D)`` step by step from ``state``
        (None: zeros and m = ``NEG_INF``); returns (y, the new state).  Decoding
        is the same call at S = 1 (``slstm_decode``)."""
        b, s, d = u.shape
        h_ = self.cfg.n_heads
        wx = mm(u, self.w_in) + self.b.to(u.dtype)  # (B, S, 4D)
        if state is None:
            z = torch.zeros((b, h_, d // h_), dtype=torch.float32, device=u.device)
            state = (z, z, z, torch.full((b, h_), NEG_INF, dtype=torch.float32, device=u.device))
        hs = []
        for t in range(s):
            state = self.cell(wx[:, t], state)
            hs.append(state[0])
        y = torch.stack(hs, dim=1).reshape(b, s, d).to(u.dtype)
        y = rms_norm(y, self.norm, self.cfg.norm_eps)
        return mm(F.gelu(mm(y, self.w_ff1), approximate="tanh"), self.w_ff2).to(u.dtype), state
