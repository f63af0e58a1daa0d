"""Whisper-style encoder-decoder: the ``audio`` family.

Counterpart of ``repro.models.encdec``.  The audio frontend is the
reference's stub: the batch brings precomputed frame embeddings ``frames``
``(B, S_frames, frontend_dim)``, which ``frontend_proj`` takes to
``d_model``.  The encoder is ``n_enc_layers`` pre-norm layers of
bidirectional attention (no positional term) and a GELU MLP, then
``enc_norm``; the decoder is ``n_layers`` layers of causal self-attention
with RoPE, cross-attention into the encoder's output and a GELU MLP; every
attention and MLP has biases.  The reference stacks each side's layers
into one leaf and scans them; here they are ``ModuleList``s run in a loop,
named ``enc_layers.<l>.<leaf>`` and ``dec_layers.<l>.<leaf>``, which
``models.convert`` maps onto the reference's stacked leaves.  Its
``jax.checkpoint`` of each layer under ``cfg.remat == "full"`` becomes
``torch.utils.checkpoint`` of each layer while grad is enabled.

The decode cache is a flat dict (``CACHE_TREE`` names where each leaf sits
in the reference's ``{"self": {"k", "v"}, "cross": {"k", "v"}}`` tree):
the decoder's self-attention k and v over ``DEC_MAX`` positions, and each
decoder layer's cross k and v of the encoder's output, all
``(n_layers, B, S, Hkv, hd)`` bf16.  ``prefill`` encodes the frames and
projects the cross k and v once; ``decode_step`` writes the step's self k
and v into its own copy of the self cache and passes the cross memory on
uncopied (at 8 × 1,500 frames of whisper-medium it is 1.18 GB).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distribution.partition import Axes
from repro_torch.models.blocks import MLP, Attention, _ones, _param
from repro_torch.models.common import ArchConfig, dense_init, make_generator, mm, rms_norm
from repro_torch.models.convert import flatten_by_layout
from repro_torch.models.transformer import _xent

DEC_FRAC = 8  # decoder seq = encoder seq // DEC_FRAC for train/prefill shapes
DEC_MAX = 1024  # decoder self-cache length during decode
# the flat cache's keys in the reference's nested cache tree
CACHE_TREE = {"self": {"k": "self_k", "v": "self_v"}, "cross": {"k": "cross_k", "v": "cross_v"}}


class EncLayer(nn.Module):
    """``_enc_layer_init``: ``ln1`` → bidirectional attention → residual,
    ``ln2`` → GELU MLP → residual."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ln1, self.ln2 = _ones(cfg.d_model, gen), _ones(cfg.d_model, gen)
        self.attn = Attention(cfg, gen, bias=True)
        self.mlp = MLP(cfg, gen, gelu=True)

    def forward(self, x):
        a, _ = self.attn(rms_norm(x, self.ln1, self.eps), None, causal=False)
        x = x + a
        return x + self.mlp(rms_norm(x, self.ln2, self.eps))


class DecLayer(nn.Module):
    """``_dec_layer_init``: ``ln1`` → causal self-attention, ``ln2`` →
    cross-attention into the encoder's output (``xattn``), ``ln3`` → GELU
    MLP, each added to the residual."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        self.eps = cfg.norm_eps
        d = cfg.d_model
        self.ln1, self.ln2, self.ln3 = _ones(d, gen), _ones(d, gen), _ones(d, gen)
        self.attn = Attention(cfg, gen, bias=True)
        self.xattn = Attention(cfg, gen, bias=True)
        self.mlp = MLP(cfg, gen, gelu=True)

    def forward(self, x, memory, positions):
        """The layer over a whole sequence; its cross k and v projected from
        ``memory`` inside the layer, as the reference's scan does."""
        a, _ = self.attn(rms_norm(x, self.ln1, self.eps), positions)
        x = x + a
        x = x + self.xattn.cross_attn(rms_norm(x, self.ln2, self.eps),
                                      self.xattn.memory_kv(memory))
        return x + self.mlp(rms_norm(x, self.ln3, self.eps))

    def decode(self, x, k_cache, v_cache, cross_k, cross_v, pos):
        """One token: the self k and v written into ``k_cache``/``v_cache``
        at ``pos`` (in place), then cross-attention over the cached memory."""
        x = x + self.attn.decode(rms_norm(x, self.ln1, self.eps), k_cache, v_cache, pos)
        x = x + self.xattn.cross_attn(rms_norm(x, self.ln2, self.eps), (cross_k, cross_v))
        return x + self.mlp(rms_norm(x, self.ln3, self.eps))


class EncDecModel(nn.Module):
    """Whisper-style encoder-decoder: ``embed``, ``final_norm``, ``lm_head``,
    ``frontend_proj``, ``n_enc_layers`` encoder layers and ``enc_norm``,
    ``n_layers`` decoder layers.

    Weights are bf16 (the norm scales ones, the biases zeros), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (``None`` →
    ``cuda``; raises without one) in the reference's order of leaves but
    not its values: carry the reference's own ``init`` across with
    ``models.convert.lm_params_from_jax``.
    """

    CACHE_TREE = CACHE_TREE

    def __init__(self, cfg: ArchConfig, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        assert cfg.enc_dec and cfg.n_enc_layers > 0
        self.cfg = cfg
        gen = make_generator(device, seed)
        self.embed = _param(dense_init(gen, (cfg.vocab, cfg.d_model), scale=1.0))
        self.final_norm = _ones(cfg.d_model, gen)
        if not cfg.tie_embeddings:
            self.lm_head = _param(dense_init(gen, (cfg.d_model, cfg.vocab)))
        self.frontend_proj = _param(dense_init(gen, (cfg.frontend_dim, cfg.d_model)))
        self.enc_layers = nn.ModuleList(EncLayer(cfg, gen) for _ in range(cfg.n_enc_layers))
        self.dec_layers = nn.ModuleList(DecLayer(cfg, gen) for _ in range(cfg.n_layers))
        self.enc_norm = _ones(cfg.d_model, gen)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _head(self, h):
        """Logits of the decoder's hidden states: ``final_norm``, then
        ``lm_head`` (the embedding's transpose under ``tie_embeddings``)."""
        h = rms_norm(h, self.final_norm, self.cfg.norm_eps)
        return mm(h, self.embed.T if self.cfg.tie_embeddings else self.lm_head)

    def _positions(self, b, s):
        return torch.arange(s, dtype=torch.int32, device=self.device).broadcast_to((b, s))

    def _remat(self) -> bool:
        return self.cfg.remat == "full" and torch.is_grad_enabled()

    # ---------------------------- encoder ----------------------------- #
    def encode(self, frames):
        """The encoder's output ``(B, S_frames, D)``: ``frames @
        frontend_proj`` through every encoder layer, then ``enc_norm``."""
        h = mm(frames, self.frontend_proj)
        remat = self._remat()
        for layer in self.enc_layers:
            if remat:  # the forward draws no random numbers: no RNG state to keep
                h = checkpoint(layer, h, use_reentrant=False, preserve_rng_state=False)
            else:
                h = layer(h)
        return rms_norm(h, self.enc_norm, self.cfg.norm_eps)

    # ---------------------------- decoder ----------------------------- #
    def _decoder(self, tokens, memory, positions):
        """The decoder's hidden states ``(B, S, D)`` (before ``final_norm``)
        of ``tokens`` over the encoder's output ``memory``."""
        h = self.embed[tokens]
        remat = self._remat()
        for layer in self.dec_layers:
            if remat:
                h = checkpoint(layer, h, memory, positions, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                h = layer(h, memory, positions)
        return h

    def forward(self, tokens: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
        """Logits ``(B, S, V)`` of ``tokens`` teacher-forced through the
        decoder over the encoding of ``frames``; no cache."""
        return self._head(self._decoder(tokens, self.encode(frames),
                                        self._positions(*tokens.shape)))

    def loss(self, batch):
        """Mean next-token cross entropy of ``batch["labels"]`` over the
        decoder's ``tokens`` and the encoder's ``frames`` (``loss_mask``
        optional); (loss, {"xent"})."""
        logits = self(batch["tokens"], batch["frames"])
        loss = _xent(logits, batch["labels"], batch.get("loss_mask"))
        return loss, {"xent": loss}

    # ---------------------------- serving ----------------------------- #
    def cache_logical(self) -> dict[str, Axes]:
        """Logical axes of ``cache_shape``'s leaves, keyed as the flat cache
        (the reference's tree through ``CACHE_TREE``)."""
        kv = Axes(None, "dp", None, "tp", None)
        return flatten_by_layout(self.CACHE_TREE, {"self": {"k": kv, "v": kv},
                                                   "cross": {"k": kv, "v": kv}})

    def cache_shape(self, batch_size: int, s_max: int) -> dict[str, torch.Tensor]:
        """The cache's leaves as meta tensors: the self k and v over
        ``DEC_MAX`` positions and the cross k and v over ``s_max`` frames,
        each ``(n_layers, B, S, Hkv, hd)`` bf16."""
        cfg = self.cfg

        def kv(s):
            return torch.empty((cfg.n_layers, batch_size, s, cfg.n_kv_heads, cfg.hd),
                               dtype=torch.bfloat16, device="meta")
        return {"self_k": kv(DEC_MAX), "self_v": kv(DEC_MAX),
                "cross_k": kv(s_max), "cross_v": kv(s_max)}

    def init_cache(self, batch_size: int, s_max: int) -> dict[str, torch.Tensor]:
        return {key: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for key, s in self.cache_shape(batch_size, s_max).items()}

    def prefill(self, batch):
        """Encode ``batch["frames"]``, project every decoder layer's cross k
        and v of it (bf16), start an empty self cache, then decode token 0
        at position 0; returns (its logits ``(B, 1, V)``, the cache)."""
        memory = self.encode(batch["frames"])
        ks, vs = zip(*(layer.xattn.memory_kv(memory) for layer in self.dec_layers))
        b = memory.shape[0]
        shapes = self.cache_shape(b, 1)
        cache = {key: torch.zeros(shapes[key].shape, dtype=shapes[key].dtype, device=self.device)
                 for key in ("self_k", "self_v")}
        cache["cross_k"] = torch.stack(ks).to(torch.bfloat16)
        cache["cross_v"] = torch.stack(vs).to(torch.bfloat16)
        bos = torch.zeros((b, 1), dtype=torch.int64, device=self.device)
        return self.decode_step(cache, {"tokens": bos, "pos": torch.tensor(0, device=self.device)})

    def decode_step(self, cache, batch):
        """One token for every sequence; batch = {tokens (B, 1), pos () or
        (B,)}.  Each decoder layer writes its k and v at ``pos`` into the
        step's own copy of the self cache (a write at or past ``DEC_MAX`` is
        dropped) and attends over the cross memory, which the new cache
        shares with ``cache``.  Returns (logits (B, 1, V), the new cache);
        ``cache`` itself is not modified."""
        k_new, v_new = cache["self_k"].clone(), cache["self_v"].clone()
        h = self.embed[batch["tokens"]]  # (B, 1, D)
        for layer, k, v, ck, cv in zip(self.dec_layers, k_new, v_new, cache["cross_k"],
                                       cache["cross_v"]):
            h = layer.decode(h, k, v, ck, cv, batch["pos"])
        new = {"self_k": k_new, "self_v": v_new,
               "cross_k": cache["cross_k"], "cross_v": cache["cross_v"]}
        return self._head(h), new
