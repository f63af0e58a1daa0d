"""Layer blocks: GQA attention and the dense MLP (SwiGLU or GELU).

Counterpart of the attention and MLP half of ``repro.models.blocks``.  The
reference's ``<block>_init`` / ``<block>_apply`` pairs over dicts of arrays
become ``nn.Module``s holding ``nn.Parameter``s under the reference's leaf
names (``wq``, ``wk``, ``wv``, ``wo``, ``q_norm``, ``k_norm``, ``w1``,
``w3``, ``w2`` …, weights laid out ``(in, out)`` as there), each with a
``forward`` for a whole sequence and, for attention, a ``decode`` against a
KV cache.  The MoE, Mamba2 and xLSTM blocks are later slices (``ROADMAP.md``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.common import (
    MASKED,
    ArchConfig,
    attention,
    dense_init,
    gelu_mlp,
    mm,
    rms_norm,
    rope,
    swiglu,
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
    """Causal GQA attention with RoPE and optional qk-norm (``attn_init``
    without biases).  The reference's biases, bidirectional attention and
    M-RoPE positions serve the audio and vlm families, whose slices add
    them (``ROADMAP.md`` items 9 and 10)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.wq = _param(dense_init(gen, (d, h * hd)))
        self.wk = _param(dense_init(gen, (d, hkv * hd)))
        self.wv = _param(dense_init(gen, (d, hkv * hd)))
        self.wo = _param(dense_init(gen, (h * hd, d), scale=1.0 / math.sqrt(h * hd)))
        if cfg.qk_norm:
            self.q_norm, self.k_norm = _ones(hd, gen), _ones(hd, gen)

    def _project_qkv(self, x):
        cfg = self.cfg
        b, s, _ = x.shape
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q, k, v = mm(x, self.wq), mm(x, self.wk), mm(x, self.wv)
        q, k, v = q.reshape(b, s, h, hd), k.reshape(b, s, hkv, hd), v.reshape(b, s, hkv, hd)
        if cfg.qk_norm:
            q = rms_norm(q, self.q_norm, cfg.norm_eps)
            k = rms_norm(k, self.k_norm, cfg.norm_eps)
        return q, k, v

    def _apply_rope(self, q, k, positions):
        theta = self.cfg.rope_theta
        return rope(q, positions, theta), rope(k, positions, theta)

    def forward(self, x, positions):
        """Full-sequence attention (train / prefill).  Returns (y, (k, v))."""
        cfg = self.cfg
        q, k, v = self._project_qkv(x)
        q, k = self._apply_rope(q, k, positions)
        y = attention(q, k, v, causal=True, window=cfg.sliding_window,
                      impl=cfg.attn_impl, q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk)
        b, s, _, _ = y.shape
        return mm(y.reshape(b, s, cfg.n_heads * cfg.hd), self.wo), (k, v)

    def decode(self, x, k_cache, v_cache, pos):
        """One-token decode against a KV cache, written IN PLACE.

        ``k_cache``/``v_cache``: ``(B, S, Hkv, hd)``; this step's k and v
        are written into them (the caller passes the step's own copy of the
        cache: ``TransformerLM.decode_step`` clones it once a step, so its
        input cache is left as it was, as the reference's functional update
        leaves it).  ``pos`` is the write index: a scalar (a uniform decode
        wave) or a ``(B,)`` vector (continuous batching: every slot at its
        own position).  Sliding-window layers treat the cache as a ring
        buffer.  A write at or past the cache's end is DROPPED, as the
        reference's out-of-range scatter is (torch indexing would raise):
        the row keeps its old value and attends over the cache without the
        new token.  Returns y ``(B, 1, D)``.
        """
        cfg = self.cfg
        b = x.shape[0]
        q, k, v = self._project_qkv(x)  # s == 1
        pos_b = torch.as_tensor(pos, device=x.device).to(torch.int64).broadcast_to((b,))
        q, k = self._apply_rope(q, k, pos_b[:, None])
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
        return mm(y.reshape(b, 1, h * hd), self.wo)


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
