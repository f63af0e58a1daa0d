"""Chunked linear-attention core of xLSTM's mLSTM.

Counterpart of the mLSTM part of ``repro.models.ssd``: the decayed
outer-product recurrence with exponential input gates

    C_t = f_t C_{t-1} + i_t k_t v_tᵀ,   n_t = f_t n_{t-1} + i_t k_t,
    y_t = (q_tᵀ C_t) / max(|q_tᵀ n_t|, 1),

in its stabilized chunked form (an intra-chunk masked product plus the
carried state, all in fp32) and as a one-token step.  The reference scans
the chunks with ``lax.scan`` over ``jax.checkpoint(step)``; here they are a
Python loop, and the per-chunk checkpoint, which only saves memory, is
left out.  Mamba2's ``ssd_chunked`` and ``ssd_decode_step`` come with the
hybrid family (``ROADMAP.md`` queue 1, item 10).
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
