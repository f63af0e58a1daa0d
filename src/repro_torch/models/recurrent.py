"""Recurrent-family models: xLSTM (mLSTM + sLSTM) and Zamba2 (the Mamba2
hybrid).

Counterpart of ``repro.models.recurrent``.  Both models are built from
macro-blocks.  An xLSTM macro is ``slstm_every - 1`` mLSTM layers (each
after its ``mlstm_ln``) and one sLSTM layer (after ``slstm_ln``), and
``n_layers // slstm_every`` macros run in a row.  A Zamba2 macro is
``attn_every`` Mamba2 layers (each after its ``mamba_ln``) and then one
application of a single SHARED attention+MLP block, whose one parameter
set serves every macro (autograd sums its gradient over the applications)
and which keeps a KV cache of its own at each application;
``round(n_layers / (attn_every + 1))`` macros run in a row.  The
reference stacks the macros (and the layers inside each) into doubly
stacked leaves and scans them; here they are ``ModuleList``s run in a
loop, named ``macros.<i>.mlstm.<j>.<leaf>``, ``macros.<i>.mlstm_ln.<j>``,
``macros.<i>.slstm.<leaf>``, ``macros.<i>.slstm_ln``;
``macros.<i>.mamba.<j>.<leaf>``, ``macros.<i>.mamba_ln.<j>`` and
``shared.<leaf>``, which ``models.convert`` maps onto the reference's
``macros/...`` and ``shared/...`` leaves.  Its ``jax.checkpoint`` of each
macro under ``cfg.remat == "full"`` becomes ``torch.utils.checkpoint`` of
each macro while grad is enabled (never at decode).

The decode cache is a flat dict, each leaf in the reference's shape and
dtype (``CACHE_TREE`` names where each sits in the reference's nested
tree).  The recurrent states have no positions: a slot of ``ServeEngine``
that is reused starts from its predecessor's state (the reference's
behaviour).  xLSTM's ``decode_step`` ignores ``pos``; Zamba2's writes the
shared block's k and v at ``pos``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distribution.partition import Axes
from repro_torch.models.blocks import MLSTM, SLSTM, Mamba2, _ones, _param
from repro_torch.models.common import ArchConfig, dense_init, make_generator, mm, rms_norm
from repro_torch.models.convert import flatten_by_layout
from repro_torch.models.ssd import NEG_INF
from repro_torch.models.transformer import Block, _xent

# the flat cache's keys in the reference's nested cache tree
XLSTM_CACHE_TREE = {"mlstm": ("mlstm_conv", ("mlstm_s", "mlstm_n", "mlstm_m")),
                    "slstm": ("slstm_h", "slstm_c", "slstm_n", "slstm_m")}
_MLSTM_KEYS = (XLSTM_CACHE_TREE["mlstm"][0], *XLSTM_CACHE_TREE["mlstm"][1])
_SLSTM_KEYS = XLSTM_CACHE_TREE["slstm"]
ZAMBA_CACHE_TREE = {"mamba": ("mamba_conv_x", "mamba_conv_bc", "mamba_ssm"),
                    "attn_kv": {"k": "attn_k", "v": "attn_v"}}
_MAMBA_KEYS = ZAMBA_CACHE_TREE["mamba"]


class Macro(nn.Module):
    """One macro-block: ``slstm_every - 1`` mLSTM layers, then an sLSTM
    layer, each pre-normed and added to the residual."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator, m_per_macro: int):
        super().__init__()
        self.eps = cfg.norm_eps
        self.mlstm = nn.ModuleList(MLSTM(cfg, gen) for _ in range(m_per_macro))
        self.mlstm_ln = nn.ParameterList(_ones(cfg.d_model, gen) for _ in range(m_per_macro))
        self.slstm = SLSTM(cfg, gen)
        self.slstm_ln = _ones(cfg.d_model, gen)

    def forward(self, x, states=None):
        """(x after the macro, its new states: a list of the mLSTM layers'
        ``(conv tail, (S̃, ñ, m))`` and the sLSTM's ``(h, c, n, m)``).
        ``states`` (None: fresh) is the same structure."""
        m_new = []
        for j, (layer, ln) in enumerate(zip(self.mlstm, self.mlstm_ln)):
            y, st = layer(rms_norm(x, ln, self.eps), None if states is None else states[0][j])
            x = x + y
            m_new.append(st)
        y, s_new = self.slstm(rms_norm(x, self.slstm_ln, self.eps),
                              None if states is None else states[1])
        return x + y, (m_new, s_new)


class XLSTMModel(nn.Module):
    """xLSTM LM: embedding, ``n_macro`` macro-blocks, ``final_norm`` and
    ``lm_head`` (the embedding's transpose under ``tie_embeddings``).

    Weights are bf16 but the mLSTM's gate projection ``wif``/``b_if`` and
    the sLSTM's bias ``b``, which are fp32, drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (``None`` → ``cuda``; raises without
    one); carry the reference's own ``init`` across with
    ``models.convert.lm_params_from_jax``.
    """

    CACHE_TREE = XLSTM_CACHE_TREE

    def __init__(self, cfg: ArchConfig, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        assert cfg.xlstm is not None
        self.cfg = cfg
        se = cfg.xlstm.slstm_every
        self.n_macro = max(1, cfg.n_layers // se)
        self.m_per_macro = se - 1
        gen = make_generator(device, seed)
        self.embed = _param(dense_init(gen, (cfg.vocab, cfg.d_model), scale=1.0))
        self.final_norm = _ones(cfg.d_model, gen)
        if not cfg.tie_embeddings:
            self.lm_head = _param(dense_init(gen, (cfg.d_model, cfg.vocab)))
        self.macros = nn.ModuleList(Macro(cfg, gen, self.m_per_macro)
                                    for _ in range(self.n_macro))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _logits(self, h):
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return mm(h, head)

    # ---------------------------- forward ---------------------------- #
    def _run(self, h, cache=None):
        """``h`` through every macro from ``cache``; returns (h, the new
        cache), or (h, None) from fresh states when ``cache`` is None."""
        remat = self.cfg.remat == "full" and torch.is_grad_enabled()
        outs = []
        for i, macro in enumerate(self.macros):
            states = None if cache is None else self._macro_states(cache, i)
            if remat:  # the forward draws no random numbers: no RNG state to keep
                h, st = checkpoint(macro, h, states, use_reentrant=False,
                                   preserve_rng_state=False)
            else:
                h, st = macro(h, states)
            outs.append(st)
        return h, None if cache is None else self._stack_states(outs)

    def _macro_states(self, cache, i):
        m_per = [(cache["mlstm_conv"][i, j],
                  (cache["mlstm_s"][i, j], cache["mlstm_n"][i, j], cache["mlstm_m"][i, j]))
                 for j in range(self.m_per_macro)]
        return m_per, tuple(cache[key][i] for key in _SLSTM_KEYS)

    def _stack_states(self, outs):
        """The macros' states as the flat cache, each leaf stacked
        ``(n_macro, m_per_macro, ...)`` (mLSTM) or ``(n_macro, ...)``."""
        mflat = [[(st[0], *st[1]) for st in m] for m, _ in outs]
        cache = {key: torch.stack([torch.stack([st[pos] for st in m]) for m in mflat])
                 for pos, key in enumerate(_MLSTM_KEYS)}
        cache.update({key: torch.stack([s[pos] for _, s in outs])
                      for pos, key in enumerate(_SLSTM_KEYS)})
        return cache

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Logits ``(B, S, V)`` of a whole sequence from fresh states."""
        h, _ = self._run(self.embed[tokens])
        return self._logits(rms_norm(h, self.final_norm, self.cfg.norm_eps))

    def loss(self, batch):
        """Mean next-token cross entropy of ``batch["labels"]``
        (``loss_mask`` optional); (loss, {"xent"})."""
        loss = _xent(self(batch["tokens"]), batch["labels"], batch.get("loss_mask"))
        return loss, {"xent": loss}

    # ---------------------------- serving ----------------------------- #
    def cache_logical(self) -> dict[str, Axes]:
        """Logical axes of ``cache_shape``'s leaves, keyed as the flat cache
        (the reference's tree through ``CACHE_TREE``)."""
        return flatten_by_layout(self.CACHE_TREE, {
            "mlstm": (
                Axes(None, None, "dp", None, "tp"),  # conv tail
                (
                    Axes(None, None, "dp", "tp", None, None),  # S̃ (falls to hd)
                    Axes(None, None, "dp", "tp", None),  # ñ
                    Axes(None, None, "dp", "tp"),  # m
                ),
            ),
            "slstm": (
                Axes(None, "dp", "tp", None),
                Axes(None, "dp", "tp", None),
                Axes(None, "dp", "tp", None),
                Axes(None, "dp", "tp"),
            ),
        })

    def cache_shape(self, batch_size: int, s_max: int) -> dict[str, torch.Tensor]:
        """The cache's leaves as meta tensors: the mLSTM's conv tail
        ``(nm, mm, B, cw-1, d_in)`` bf16 and ``S̃ (nm, mm, B, h, hd, hd)``,
        ``ñ``, ``m``; the sLSTM's h, c, n ``(nm, B, h, hd)`` and m; fp32
        but the tail.  ``s_max`` is unused: the states do not grow."""
        cfg = self.cfg
        d_in = int(cfg.d_model * cfg.xlstm.proj_factor)
        h = cfg.n_heads
        hd_i, hd = d_in // h, cfg.d_model // h
        cw = cfg.xlstm.conv_width
        nm, mp, b = self.n_macro, self.m_per_macro, batch_size
        f32 = torch.float32
        shapes = {"mlstm_conv": ((nm, mp, b, cw - 1, d_in), torch.bfloat16),
                  "mlstm_s": ((nm, mp, b, h, hd_i, hd_i), f32),
                  "mlstm_n": ((nm, mp, b, h, hd_i), f32),
                  "mlstm_m": ((nm, mp, b, h), f32),
                  **{key: ((nm, b, h, hd), f32) for key in _SLSTM_KEYS[:3]},
                  "slstm_m": ((nm, b, h), f32)}
        return {key: torch.empty(shape, dtype=dt, device="meta")
                for key, (shape, dt) in shapes.items()}

    def init_cache(self, batch_size: int, s_max: int) -> dict[str, torch.Tensor]:
        """Zeros, but the stabilizers at -1e30."""
        cache = {key: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                 for key, s in self.cache_shape(batch_size, s_max).items()}
        for key in ("mlstm_m", "slstm_m"):
            cache[key].fill_(NEG_INF)
        return cache

    def prefill(self, batch):
        """Full-sequence forward of ``batch["tokens"]`` from fresh states;
        returns (last-token logits ``(B, 1, V)``, the cache after it)."""
        h = self.embed[batch["tokens"]]
        h, cache = self._run(h, self.init_cache(h.shape[0], 0))
        h = rms_norm(h, self.final_norm, self.cfg.norm_eps)
        return self._logits(h[:, -1:, :]), cache

    def decode_step(self, cache, batch):
        """One token for every sequence, ``batch["tokens"]`` ``(B, 1)``
        through the chunked mLSTM core at S = 1 and the sLSTM (the
        reference's ``_run``; ``pos`` is ignored).  Returns (logits
        ``(B, 1, V)``, the new cache); ``cache`` is not modified."""
        h, new = self._run(self.embed[batch["tokens"]], cache)
        return self._logits(rms_norm(h, self.final_norm, self.cfg.norm_eps)), new


# ===================================================================== #
# Zamba2 hybrid
# ===================================================================== #
class ZambaMacro(nn.Module):
    """A macro's own layers: ``attn_every`` pre-normed Mamba2 layers, each
    added to the residual.  The shared block that ends the macro is the
    model's (``ZambaModel.shared``)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator, m_per_macro: int):
        super().__init__()
        self.eps = cfg.norm_eps
        self.mamba = nn.ModuleList(Mamba2(cfg, gen) for _ in range(m_per_macro))
        self.mamba_ln = nn.ParameterList(_ones(cfg.d_model, gen) for _ in range(m_per_macro))

    def forward(self, x, states=None, decode=False):
        """(x after the Mamba2 layers, their new states, one ``(x tail, B/C
        tail, SSM state)`` a layer).  ``states`` (None: fresh) is the same
        structure; ``decode`` takes one token through ``Mamba2.decode``."""
        new = []
        for j, (layer, ln) in enumerate(zip(self.mamba, self.mamba_ln)):
            st = None if states is None else states[j]
            fn = layer.decode if decode else layer
            y, st = fn(rms_norm(x, ln, self.eps), st)
            x = x + y
            new.append(st)
        return x, new


class ZambaModel(nn.Module):
    """Zamba2 LM: embedding, ``n_macro`` macro-blocks of ``attn_every``
    Mamba2 layers each followed by the one ``shared`` block (a dense
    ``Block``: ``ln1``, attention, ``ln2``, SwiGLU MLP), ``final_norm`` and
    ``lm_head``.

    Weights are bf16 but Mamba2's ``a_log``, ``d_skip`` and ``dt_bias``,
    which are fp32, drawn from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (``None`` → ``cuda``; raises without one); carry the
    reference's own ``init`` across with ``models.convert.lm_params_from_jax``.
    """

    CACHE_TREE = ZAMBA_CACHE_TREE

    def __init__(self, cfg: ArchConfig, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        assert cfg.ssm is not None and cfg.attn_every > 0
        self.cfg = cfg
        self.m_per_macro = cfg.attn_every
        self.n_macro = max(1, round(cfg.n_layers / (cfg.attn_every + 1)))
        gen = make_generator(device, seed)
        self.embed = _param(dense_init(gen, (cfg.vocab, cfg.d_model), scale=1.0))
        self.final_norm = _ones(cfg.d_model, gen)
        if not cfg.tie_embeddings:
            self.lm_head = _param(dense_init(gen, (cfg.d_model, cfg.vocab)))
        self.macros = nn.ModuleList(ZambaMacro(cfg, gen, self.m_per_macro)
                                    for _ in range(self.n_macro))
        self.shared = Block(cfg, gen)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _logits(self, h):
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return mm(h, head)

    def _positions(self, b, s):
        return torch.arange(s, dtype=torch.int32, device=self.device).broadcast_to((b, s))

    # ---------------------------- forward ---------------------------- #
    def _macro(self, i, h, positions, states):
        """Macro ``i``'s Mamba2 layers from ``states``, then the shared
        block over the whole sequence: (h, the layers' states, (k, v))."""
        h, new = self.macros[i](h, states)
        h, kv, _ = self.shared(h, positions)
        return h, new, kv

    def _run(self, h, cache=None):
        """``h`` through every macro, the Mamba2 layers from ``cache``'s
        states (None: fresh); returns (h, the new cache with the shared
        block's k and v of the sequence, bf16), or (h, None) from fresh
        states when ``cache`` is None."""
        positions = self._positions(*h.shape[:2])
        remat = self.cfg.remat == "full" and torch.is_grad_enabled()
        outs, ks, vs = [], [], []
        for i in range(self.n_macro):
            states = None if cache is None else self._macro_states(cache, i)
            if remat:  # the forward draws no random numbers: no RNG state to keep
                h, st, (k, v) = checkpoint(self._macro, i, h, positions, states,
                                           use_reentrant=False, preserve_rng_state=False)
            else:
                h, st, (k, v) = self._macro(i, h, positions, states)
            if cache is not None:
                outs.append(st)
                ks.append(k.to(torch.bfloat16))
                vs.append(v.to(torch.bfloat16))
        if cache is None:
            return h, None
        return h, {**self._stack_states(outs), "attn_k": torch.stack(ks),
                   "attn_v": torch.stack(vs)}

    def _macro_states(self, cache, i):
        return [tuple(cache[key][i, j] for key in _MAMBA_KEYS) for j in range(self.m_per_macro)]

    def _stack_states(self, outs):
        """The macros' Mamba2 states as the flat cache's leaves, each
        stacked ``(n_macro, m_per_macro, ...)``."""
        return {key: torch.stack([torch.stack([st[pos] for st in m]) for m in outs])
                for pos, key in enumerate(_MAMBA_KEYS)}

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Logits ``(B, S, V)`` of a whole sequence from fresh states."""
        h, _ = self._run(self.embed[tokens])
        return self._logits(rms_norm(h, self.final_norm, self.cfg.norm_eps))

    def loss(self, batch):
        """Mean next-token cross entropy of ``batch["labels"]``
        (``loss_mask`` optional); (loss, {"xent"})."""
        loss = _xent(self(batch["tokens"]), batch["labels"], batch.get("loss_mask"))
        return loss, {"xent": loss}

    # ---------------------------- serving ----------------------------- #
    def cache_logical(self) -> dict[str, Axes]:
        """Logical axes of ``cache_shape``'s leaves, keyed as the flat cache
        (the reference's tree through ``CACHE_TREE``)."""
        return flatten_by_layout(self.CACHE_TREE, {
            "mamba": (
                Axes(None, None, "dp", None, "tp"),  # conv tail x
                Axes(None, None, "dp", None, "tp"),  # conv tail bc
                Axes(None, None, "dp", "tp", None, None),  # ssm state
            ),
            "attn_kv": {
                "k": Axes(None, "dp", None, "tp", None),
                "v": Axes(None, "dp", None, "tp", None),
            },
        })

    def cache_shape(self, batch_size: int, s_max: int) -> dict[str, torch.Tensor]:
        """The cache's leaves as meta tensors: the Mamba2 layers' conv tails
        ``(nm, mm, B, cw-1, d_in)`` and ``(nm, mm, B, cw-1, 2·d_state)``
        bf16 and SSM states ``(nm, mm, B, H, d_state, head_dim)`` fp32; the
        shared block's k and v at each application ``(nm, B, s_max, Hkv,
        hd)`` bf16."""
        cfg, ssm = self.cfg, self.cfg.ssm
        d_in = ssm.expand * cfg.d_model
        nm, mp, b, cw = self.n_macro, self.m_per_macro, batch_size, ssm.conv_width
        bf16 = torch.bfloat16
        kv = ((nm, b, s_max, cfg.n_kv_heads, cfg.hd), bf16)
        shapes = {"mamba_conv_x": ((nm, mp, b, cw - 1, d_in), bf16),
                  "mamba_conv_bc": ((nm, mp, b, cw - 1, 2 * ssm.d_state), bf16),
                  "mamba_ssm": ((nm, mp, b, d_in // ssm.head_dim, ssm.d_state, ssm.head_dim),
                                torch.float32),
                  "attn_k": kv, "attn_v": kv}
        return {key: torch.empty(shape, dtype=dt, device="meta")
                for key, (shape, dt) in shapes.items()}

    def init_cache(self, batch_size: int, s_max: int) -> dict[str, torch.Tensor]:
        return {key: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for key, s in self.cache_shape(batch_size, s_max).items()}

    def prefill(self, batch):
        """Full-sequence forward of ``batch["tokens"]`` from fresh states;
        returns (last-token logits ``(B, 1, V)``, the cache after it, whose
        k and v hold the prompt's S positions, as the reference's)."""
        h = self.embed[batch["tokens"]]
        h, cache = self._run(h, self.init_cache(h.shape[0], 0))
        h = rms_norm(h, self.final_norm, self.cfg.norm_eps)
        return self._logits(h[:, -1:, :]), cache

    def decode_step(self, cache, batch):
        """One token for every sequence; batch = {tokens (B, 1), pos () or
        (B,)}.  Each macro's Mamba2 layers take one recurrent step, then the
        shared block writes its k and v at ``pos`` into the step's own copy
        of that application's cache (a write at or past ``s_max`` is
        dropped) and attends over it.  Returns (logits (B, 1, V), the new
        cache); ``cache`` itself is not modified."""
        k_new, v_new = cache["attn_k"].clone(), cache["attn_v"].clone()
        h = self.embed[batch["tokens"]]  # (B, 1, D)
        outs = []
        for i, macro in enumerate(self.macros):
            h, st = macro(h, self._macro_states(cache, i), decode=True)
            h = self.shared.decode(h, k_new[i], v_new[i], batch["pos"])
            outs.append(st)
        new = {**self._stack_states(outs), "attn_k": k_new, "attn_v": v_new}
        return self._logits(rms_norm(h, self.final_norm, self.cfg.norm_eps)), new
