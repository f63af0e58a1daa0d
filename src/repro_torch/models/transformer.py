"""Decoder-only transformer LM: the ``dense``, ``moe`` and ``vlm`` families.

Counterpart of ``repro.models.transformer``.  The reference stacks its
layers into one pytree with a leading L dim and drives them with
``lax.scan``; here they are a ``ModuleList`` run in a loop, and the KV cache
keeps the reference's ``(L, B, S_kv, Hkv, hd)`` bf16 layout.  The
reference's ``shard(...)`` calls are identities unless logical-axis rules
are installed, which no test or example does, so they are left out.  Its
``jax.checkpoint`` of each layer under ``cfg.remat == "full"`` becomes
``torch.utils.checkpoint`` of each ``Block`` while grad is enabled: the
backward recomputes a layer's activations from its input, which changes
memory, never values (every op of a layer, the MoE's dispatch included, is
deterministic).  A ``moe`` layer holds ``moe`` in place of ``mlp`` and adds
its router's load-balance loss to ``loss``; a ``vlm`` model puts
``vis_embeds @ frontend_proj`` before the tokens and rotates by the batch's
M-RoPE ``pos3``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distribution.partition import Axes
from repro_torch.models.blocks import MLP, Attention, MoE, _ones, _param
from repro_torch.models.common import (ArchConfig, dense_init, make_generator, mm, not_ported,
                                        rms_norm)


def _xent(logits, labels, mask=None):
    """Mean next-token cross entropy; logits (B,S,V)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


class Block(nn.Module):
    """One pre-norm layer: ``ln1`` → attention → residual, ``ln2`` → MLP (or
    MoE) → residual (the reference's ``_layer_init`` tree: ``attn`` and
    ``mlp``, or ``moe`` in the moe family)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ln1, self.ln2 = _ones(cfg.d_model, gen), _ones(cfg.d_model, gen)
        self.attn = Attention(cfg, gen)
        if cfg.family == "moe":
            self.moe = MoE(cfg, gen)
        else:
            self.mlp = MLP(cfg, gen)

    def _ffn(self, x):
        """(the MLP's or the MoE's output, the MoE's aux or None)."""
        if hasattr(self, "moe"):
            return self.moe(x)
        return self.mlp(x), None

    def forward(self, x, positions, pos3=None):
        """(x after the layer, (k, v), the layer's aux or None)."""
        a, kv = self.attn(rms_norm(x, self.ln1, self.eps), positions, pos3)
        x = x + a
        m, aux = self._ffn(rms_norm(x, self.ln2, self.eps))
        return x + m, kv, aux

    def decode(self, x, k_cache, v_cache, pos, pos3=None):
        x = x + self.attn.decode(rms_norm(x, self.ln1, self.eps), k_cache, v_cache, pos, pos3)
        return x + self._ffn(rms_norm(x, self.ln2, self.eps))[0]


class TransformerLM(nn.Module):
    """Llama-style LM: embedding, ``n_layers`` blocks, ``final_norm`` and
    ``lm_head`` (the embedding's transpose under ``tie_embeddings``); the
    families ``dense``, ``moe`` (top-k MoE layers) and ``vlm`` (a
    ``frontend_proj`` of patch embeddings put before the tokens, M-RoPE).

    Weights are bf16, drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (``None`` → ``cuda``; raises without one), so two models
    of one config and seed on one device are equal; the draws follow the
    reference's order of leaves but not its values: carry the reference's
    own ``init`` across with ``models.convert.lm_params_from_jax``.
    """

    def __init__(self, cfg: ArchConfig, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        if cfg.family not in ("dense", "moe", "vlm") or cfg.enc_dec:
            raise not_ported(cfg)
        self.cfg = cfg
        gen = make_generator(device, seed)
        self.embed = _param(dense_init(gen, (cfg.vocab, cfg.d_model), scale=1.0))
        self.final_norm = _ones(cfg.d_model, gen)
        if not cfg.tie_embeddings:
            self.lm_head = _param(dense_init(gen, (cfg.d_model, cfg.vocab)))
        if cfg.frontend:
            self.frontend_proj = _param(dense_init(gen, (cfg.frontend_dim, cfg.d_model)))
        self.layers = nn.ModuleList(Block(cfg, gen) for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _logits(self, h):
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return mm(h, head)

    def _positions(self, b, s):
        return torch.arange(s, dtype=torch.int32, device=self.device).broadcast_to((b, s))

    def _embed_inputs(self, batch):
        """The token embeddings; in the vlm family ``vis_embeds @
        frontend_proj``, cast to the embedding's dtype, before them."""
        h = self.embed[batch["tokens"]]  # (B, S_text, D)
        if self.cfg.family == "vlm":
            vis = mm(batch["vis_embeds"], self.frontend_proj)  # (B, S_vis, D)
            h = torch.cat([vis.to(h.dtype), h], dim=1)
        return h

    def _pos3(self, batch):
        return batch.get("pos3") if self.cfg.mrope else None

    # ---------------------------- forward ---------------------------- #
    def _hidden(self, batch):
        """(final-normed hidden states ``(B, S, D)`` of the whole sequence,
        the layers' summed aux; a zero in the dense and vlm families)."""
        h = self._embed_inputs(batch)
        positions, pos3 = self._positions(*h.shape[:2]), self._pos3(batch)
        remat = self.cfg.remat == "full" and torch.is_grad_enabled()
        auxs = []
        for layer in self.layers:
            if remat:  # the forward draws no random numbers: no RNG state to keep
                h, _, aux = checkpoint(layer, h, positions, pos3, use_reentrant=False,
                                       preserve_rng_state=False)
            else:
                h, _, aux = layer(h, positions, pos3)
            if aux is not None:
                auxs.append(aux)
        aux = torch.stack(auxs).sum() if auxs else torch.zeros((), device=h.device)
        return rms_norm(h, self.final_norm, self.cfg.norm_eps), aux

    def forward(self, tokens: torch.Tensor, vis_embeds=None, pos3=None) -> torch.Tensor:
        """Logits ``(B, S, V)`` of a whole sequence, no cache (in the vlm
        family over the patch prefix and the tokens)."""
        batch = {"tokens": tokens, "vis_embeds": vis_embeds, "pos3": pos3}
        return self._logits(self._hidden(batch)[0])

    def loss(self, batch):
        """Mean next-token cross entropy of ``batch["labels"]`` (the text
        tail's positions in the vlm family; ``loss_mask`` optional) plus
        0.01 × the router's aux; (loss, {"xent", "aux"})."""
        h, aux = self._hidden(batch)
        s_text = batch["labels"].shape[1]
        loss = _xent(self._logits(h[:, -s_text:]), batch["labels"], batch.get("loss_mask"))
        return loss + 0.01 * aux, {"xent": loss, "aux": aux}

    # ---------------------------- serving ----------------------------- #
    def cache_logical(self) -> dict[str, Axes]:
        """Logical axes of ``cache_shape``'s leaves, keyed as the cache."""
        kv = Axes(None, "dp", None, "tp", None)  # (L, B, S, Hkv, hd)
        return {"k": kv, "v": kv}

    def cache_shape(self, batch_size: int, s_max: int) -> dict[str, torch.Tensor]:
        """The cache's leaves as meta tensors (shape and dtype, no storage)."""
        cfg = self.cfg
        s_kv = min(s_max, cfg.sliding_window) if cfg.sliding_window else s_max
        shape = (cfg.n_layers, batch_size, s_kv, cfg.n_kv_heads, cfg.hd)
        return {key: torch.empty(shape, dtype=torch.bfloat16, device="meta")
                for key in ("k", "v")}

    def init_cache(self, batch_size: int, s_max: int) -> dict[str, torch.Tensor]:
        return {key: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for key, s in self.cache_shape(batch_size, s_max).items()}

    def prefill(self, batch):
        """Full-sequence forward of ``batch`` (``loss``'s inputs, no labels);
        returns (last-token logits, cache).  The cache holds the sequence's
        S positions (the window's last ones under a sliding window), bf16."""
        cfg = self.cfg
        h = self._embed_inputs(batch)
        positions, pos3 = self._positions(*h.shape[:2]), self._pos3(batch)
        ks, vs = [], []
        for layer in self.layers:
            h, (k, v), _ = layer(h, positions, pos3)
            if cfg.sliding_window:
                k, v = k[:, -cfg.sliding_window:], v[:, -cfg.sliding_window:]
            ks.append(k.to(torch.bfloat16))
            vs.append(v.to(torch.bfloat16))
        h = rms_norm(h, self.final_norm, cfg.norm_eps)
        return self._logits(h[:, -1:, :]), {"k": torch.stack(ks), "v": torch.stack(vs)}

    def decode_step(self, cache, batch):
        """One token for every sequence; batch = {tokens (B,1), pos () or
        (B,), pos3 (3,B,1) optional}.  Returns (logits (B,1,V), new cache);
        ``cache`` itself is not modified."""
        new = {key: leaf.clone() for key, leaf in cache.items()}
        h = self.embed[batch["tokens"]]  # (B, 1, D)
        pos3 = batch.get("pos3")
        for layer, k, v in zip(self.layers, new["k"], new["v"]):
            h = layer.decode(h, k, v, batch["pos"], pos3)
        return self._logits(rms_norm(h, self.final_norm, self.cfg.norm_eps)), new
