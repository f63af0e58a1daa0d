"""Chunked state-space / linear-attention cores: Mamba2's SSD and xLSTM's
mLSTM.

Counterpart of ``repro.models.ssd``.  Both share a decayed outer-product
recurrence

    S_t = a_t · S_{t-1} + b_t · (k_t ⊗ v_t),     y_t = q_t · S_t

in a chunked form (an intra-chunk masked product plus the state carried
across chunks, all in fp32) and as a one-token step.  ``ssd_chunked`` is
Mamba2's (decay a ∈ (0, 1], no normalizer, no stabilizer);
``mlstm_chunked`` is the mLSTM's with exponential input gates

    C_t = f_t C_{t-1} + i_t k_t v_tᵀ,   n_t = f_t n_{t-1} + i_t k_t,
    y_t = (q_tᵀ C_t) / max(|q_tᵀ n_t|, 1),

in its stabilized form.  The reference scans the chunks with ``lax.scan``
over ``jax.checkpoint(step)``; here they are a Python loop, and the
per-chunk checkpoint, which only saves memory, is left out: a model's
remat of each macro-block already bounds what its backward keeps.  Both
return the final state, so a prefill seeds decoding.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # the stabilizer's start: finite, so m - m and exp(lf + m - m_new) stay finite


def _scale(n: int, like: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(float32(n))`` rounded in fp32 at each op, as the reference
    computes it (a Python float would round once from fp64)."""
    return 1.0 / torch.sqrt(torch.tensor(float(n), dtype=torch.float32, device=like.device))


def _exp_neg(m):
    """``exp(-m)``, the normalizer's floor: where it overflows (m below
    about -88.7) the reference's infinity, held as a constant, so the
    backward does not multiply the zero gradient there by it."""
    e = torch.exp(-m)
    big = torch.isinf(e)
    return torch.where(big, e.detach(), torch.exp(torch.where(big, 0.0, -m)))


def ssd_chunked(la, q, k, v, s0=None, chunk: int = 256):
    """Mamba2's SSD in chunks of ``chunk`` tokens.

    ``la``: ``(B, S, H)`` log decay per token (<= 0); ``q`` (C_t), ``k``
    (B_t): ``(B, S, N)``, shared across heads; ``v``: ``(B, S, H, P)``, the
    dt-scaled inputs; ``s0``: ``(B, H, N, P)`` fp32 initial state (None:
    zeros).  Returns (y ``(B, S, H, P)`` in ``v``'s dtype, the final state).
    The reference's op order, in fp32: the inclusive cumsum ``L`` of
    ``la`` a chunk, ``exp(L_j - L_s)`` for s <= j inside it, ``exp(L_j)``
    on the carried state, ``exp(L_Q - L_s)`` into the state at the chunk's
    end.  The forward gives the reference's values; its backward is the
    reference's wherever that is finite, and finite where the reference's
    is not: past a cumulative decay of about -88.7 in a chunk the masked
    pairs' ``exp(L_j - L_s)`` (s > j) overflow to infinity, which the
    reference's backward multiplies by a zero gradient.
    """
    b, s, h = la.shape
    n, p = q.shape[-1], v.shape[-1]
    cq = min(chunk, s)
    assert s % cq == 0, (s, cq)
    dev = la.device
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=dev) if s0 is None else s0
    idx = torch.arange(cq, device=dev)
    tri = (idx[:, None] >= idx[None, :])[None, :, :, None]  # j >= s
    ys = []
    for c0 in range(0, s, cq):
        la_b = la[:, c0:c0 + cq].float()
        q_b, k_b, v_b = q[:, c0:c0 + cq].float(), k[:, c0:c0 + cq].float(), v[:, c0:c0 + cq].float()
        lcum = torch.cumsum(la_b, dim=1)  # (B,Q,H), inclusive
        diff = lcum[:, :, None, :] - lcum[:, None, :, :]  # (B,Q,Q,H): L_j - L_s
        # the masked (s > j) exponents are positive and may overflow: mask
        # them before the exp, then zero them (the reference's values)
        w = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
        qk = torch.einsum("bjn,bsn->bjs", q_b, k_b)
        y_intra = torch.einsum("bjsh,bshp->bjhp", qk[:, :, :, None] * w, v_b)
        # inter-chunk: y_j += exp(L_j) q_j · S_prev
        qdec = q_b[:, :, None, :] * torch.exp(lcum)[..., None]  # (B,Q,H,N)
        y_inter = torch.einsum("bjhn,bhnp->bjhp", qdec, state)
        ys.append((y_intra + y_inter).to(v.dtype))
        # state update: S = exp(L_Q) S_prev + sum_s exp(L_Q - L_s) k_s v_s
        ltot = lcum[:, -1, :]  # (B,H)
        kdec = k_b[:, :, None, :] * torch.exp(ltot[:, None, :] - lcum)[..., None]  # (B,Q,H,N)
        state = state * torch.exp(ltot)[:, :, None, None] + torch.einsum(
            "bshn,bshp->bhnp", kdec, v_b)
    return torch.cat(ys, dim=1), state


def ssd_decode_step(la, q, k, v, state):
    """One token of Mamba2's recurrence: ``la`` ``(B, H)``, ``q``, ``k``
    ``(B, N)``, ``v`` ``(B, H, P)``, ``state`` ``(B, H, N, P)`` fp32;
    returns (y ``(B, H, P)`` in ``v``'s dtype, the new state)."""
    a = torch.exp(la.float())[:, :, None, None]
    new_state = a * state + torch.einsum("bn,bhp->bhnp", k.float(), v.float())
    y = torch.einsum("bn,bhnp->bhp", q.float(), new_state)
    return y.to(v.dtype), new_state


def mlstm_chunked(lf, li, q, k, v, state=None, chunk: int = 256):
    """Stabilized chunked mLSTM.

    ``lf``, ``li``: ``(B, S, H)`` log forget and log input gates; ``q``,
    ``k``: ``(B, S, H, N)``; ``v``: ``(B, S, H, P)``.  The carried state is
    ``(S̃, ñ, m)`` (``(B, H, N, P)``, ``(B, H, N)``, ``(B, H)``, fp32) with
    the true ``C = S̃·eᵐ``, ``n = ñ·eᵐ``; ``None`` starts from zeros and
    ``m = NEG_INF``.  Returns (y ``(B, S, H, P)`` in ``v``'s dtype, the
    final state).  The forward gives the reference's values; its backward
    is the reference's wherever that is finite, and finite where the
    reference's overflows (a masked exponent or the normalizer's floor
    ``exp(-m)`` past fp32's range gives it ``0 · inf``).
    """
    b, s, h = lf.shape
    n = q.shape[-1]
    p = v.shape[-1]
    cq = min(chunk, s)
    assert s % cq == 0, (s, cq)
    dev = lf.device
    if state is None:
        st = torch.zeros((b, h, n, p), dtype=torch.float32, device=dev)
        nt = torch.zeros((b, h, n), dtype=torch.float32, device=dev)
        mt = torch.full((b, h), NEG_INF, dtype=torch.float32, device=dev)
    else:
        st, nt, mt = state
    idx = torch.arange(cq, device=dev)
    tri = (idx[:, None] >= idx[None, :])[None, :, :, None]
    scale = _scale(n, lf)
    ys = []
    for c0 in range(0, s, cq):
        lf_b, li_b = lf[:, c0:c0 + cq].float(), li[:, c0:c0 + cq].float()
        q_b, k_b, v_b = q[:, c0:c0 + cq].float(), k[:, c0:c0 + cq].float(), v[:, c0:c0 + cq].float()
        lcum = torch.cumsum(lf_b, dim=1)  # (B,Q,H)
        # log weight of source s at target j: L_j - L_s + li_s (s <= j)
        c_src = li_b - lcum
        run_max = torch.cummax(c_src, dim=1).values  # max_{s<=j} (li_s - L_s)
        e_carry = mt[:, None, :]  # m_prev (B,1,H)
        m_new = torch.maximum(lcum + run_max, lcum + e_carry)  # (B,Q,H)
        d = lcum[:, :, None, :] + c_src[:, None, :, :] - m_new[:, :, None, :]
        # the masked (s > j) exponents may overflow: mask them before the
        # exp (exp(NEG_INF) is 0, the reference's value), so the backward
        # never multiplies a zero gradient by an infinite exp
        w = torch.exp(torch.where(tri, d, NEG_INF))  # (B,Q,Q,H)
        qs = q_b * scale
        scores = torch.einsum("bjhn,bshn->bjsh", qs, k_b) * w
        y_num = torch.einsum("bjsh,bshp->bjhp", scores, v_b)
        den = torch.sum(scores, dim=2)  # q_j · n_j, intra part (B,Q,H)
        # carry-in contribution, scaled by exp(L_j + m_prev - m_j)
        cw = torch.exp(lcum + e_carry - m_new)
        y_num = y_num + torch.einsum("bjhn,bhnp->bjhp", qs, st) * cw[..., None]
        den = den + torch.einsum("bjhn,bhn->bjh", qs, nt) * cw
        denom = torch.maximum(torch.abs(den), _exp_neg(m_new))
        ys.append((y_num / denom[..., None]).to(v.dtype))
        # ---- state update to the chunk's end ----
        ltot = lcum[:, -1, :]  # (B,H)
        m_end = m_new[:, -1, :]
        w_end = torch.exp(ltot[:, None, :] + c_src - m_end[:, None, :])  # (B,Q,H)
        kw = k_b * w_end[..., None]
        kv = torch.einsum("bshn,bshp->bhnp", kw, v_b)
        ksum = torch.einsum("bshn->bhn", kw)
        carry_scale = torch.exp(ltot + mt - m_end)[:, :, None]
        st = st * carry_scale[..., None] + kv
        nt = nt * carry_scale + ksum
        mt = m_end
    return torch.cat(ys, dim=1), (st, nt, mt)


def mlstm_decode_step(lf, li, q, k, v, state):
    """One token of the stabilized recurrence: ``lf``, ``li`` ``(B, H)``,
    ``q``, ``k`` ``(B, H, N)``, ``v`` ``(B, H, P)``; returns (y ``(B, H, P)``
    in ``v``'s dtype, the new ``(S̃, ñ, m)``)."""
    st, nt, mt = state
    lf, li = lf.float(), li.float()
    m_new = torch.maximum(lf + mt, li)
    f = torch.exp(lf + mt - m_new)[:, :, None]
    i = torch.exp(li - m_new)[:, :, None]
    k32 = k.float()
    st_new = st * f[..., None] + i[..., None] * torch.einsum("bhn,bhp->bhnp", k32, v.float())
    nt_new = nt * f + i * k32
    qs = q.float() * _scale(q.shape[-1], q)
    num = torch.einsum("bhn,bhnp->bhp", qs, st_new)
    den = torch.maximum(torch.abs(torch.einsum("bhn,bhn->bh", qs, nt_new)), torch.exp(-m_new))
    return (num / den[..., None]).to(v.dtype), (st_new, nt_new, m_new)
