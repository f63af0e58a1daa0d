"""Decoder-only transformer LM, the ``dense`` family.

Counterpart of ``repro.models.transformer``.  The reference stacks its
layers into one pytree with a leading L dim and drives them with
``lax.scan``; here they are a ``ModuleList`` run in a loop, and the KV cache
keeps the reference's ``(L, B, S_kv, Hkv, hd)`` bf16 layout.  The
reference's ``shard(...)`` calls are identities unless logical-axis rules
are installed, which no test or example does, so they are left out, as are
``jax.checkpoint`` and ``remat`` (they only matter under a gradient).  The
``moe`` and ``vlm`` families raise until their slice (``ROADMAP.md``).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.blocks import MLP, Attention, _ones, _param
from repro_torch.models.common import ArchConfig, dense_init, mm, not_ported, rms_norm


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
    """One pre-norm layer: ``ln1`` → attention → residual, ``ln2`` → MLP →
    residual (the reference's ``_layer_init`` tree, ``attn`` and ``mlp``)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ln1, self.ln2 = _ones(cfg.d_model, gen), _ones(cfg.d_model, gen)
        self.attn = Attention(cfg, gen)
        self.mlp = MLP(cfg, gen)

    def forward(self, x, positions):
        a, kv = self.attn(rms_norm(x, self.ln1, self.eps), positions)
        x = x + a
        return x + self.mlp(rms_norm(x, self.ln2, self.eps)), kv

    def decode(self, x, k_cache, v_cache, pos):
        x = x + self.attn.decode(rms_norm(x, self.ln1, self.eps), k_cache, v_cache, pos)
        return x + self.mlp(rms_norm(x, self.ln2, self.eps))


class TransformerLM(nn.Module):
    """Dense llama-style LM: embedding, ``n_layers`` blocks, ``final_norm``
    and ``lm_head`` (the embedding's transpose under ``tie_embeddings``).

    Weights are bf16, drawn from a ``torch.Generator`` seeded with 0 on
    ``device`` (``None`` → ``cuda``; raises without one), so two models of
    one config on one device are equal; the draws follow the reference's
    order of leaves but not its values: carry the reference's own ``init``
    across with ``models.convert.lm_params_from_jax``.
    """

    def __init__(self, cfg: ArchConfig, device: str | torch.device | None = None):
        super().__init__()
        if cfg.family != "dense" or cfg.enc_dec:
            raise not_ported(cfg)
        self.cfg = cfg
        gen = torch.Generator(device=resolve_device(device)).manual_seed(0)
        self.embed = _param(dense_init(gen, (cfg.vocab, cfg.d_model), scale=1.0))
        self.final_norm = _ones(cfg.d_model, gen)
        if not cfg.tie_embeddings:
            self.lm_head = _param(dense_init(gen, (cfg.d_model, cfg.vocab)))
        self.layers = nn.ModuleList(Block(cfg, gen) for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _logits(self, h):
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return mm(h, head)

    def _positions(self, b, s):
        return torch.arange(s, dtype=torch.int32, device=self.device).broadcast_to((b, s))

    # ---------------------------- forward ---------------------------- #
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Logits ``(B, S, V)`` of a whole sequence, no cache."""
        h = self.embed[tokens]
        positions = self._positions(*tokens.shape)
        for layer in self.layers:
            h, _ = layer(h, positions)
        return self._logits(rms_norm(h, self.final_norm, self.cfg.norm_eps))

    def loss(self, batch):
        """Mean next-token cross entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (``loss_mask`` optional); (loss, metrics)."""
        loss = _xent(self(batch["tokens"]), batch["labels"], batch.get("loss_mask"))
        aux = torch.zeros((), device=loss.device)  # no router loss in a dense model
        return loss + 0.01 * aux, {"xent": loss, "aux": aux}

    # ---------------------------- serving ----------------------------- #
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
        """Full-sequence forward; returns (last-token logits, cache).  The
        cache holds the prompt's S positions (the window's last ones under
        a sliding window), bf16."""
        cfg = self.cfg
        tokens = batch["tokens"]
        h = self.embed[tokens]
        positions = self._positions(*tokens.shape)
        ks, vs = [], []
        for layer in self.layers:
            h, (k, v) = layer(h, positions)
            if cfg.sliding_window:
                k, v = k[:, -cfg.sliding_window:], v[:, -cfg.sliding_window:]
            ks.append(k.to(torch.bfloat16))
            vs.append(v.to(torch.bfloat16))
        h = rms_norm(h, self.final_norm, cfg.norm_eps)
        return self._logits(h[:, -1:, :]), {"k": torch.stack(ks), "v": torch.stack(vs)}

    def decode_step(self, cache, batch):
        """One token for every sequence; batch = {tokens (B,1), pos () or
        (B,)}.  Returns (logits (B,1,V), new cache); ``cache`` itself is
        not modified."""
        new = {key: leaf.clone() for key, leaf in cache.items()}
        h = self.embed[batch["tokens"]]  # (B, 1, D)
        for layer, k, v in zip(self.layers, new["k"], new["v"]):
            h = layer.decode(h, k, v, batch["pos"])
        return self._logits(rms_norm(h, self.final_norm, self.cfg.norm_eps)), new
