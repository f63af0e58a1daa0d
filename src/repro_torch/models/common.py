"""Shared model components: configs, norms, rotary embeddings, MLPs,
memory-efficient attention.

Counterpart of ``repro.models.common``.  The configs are plain dataclasses,
copied field for field so every config module imports unchanged.  The
functions are plain torch ops with the reference's precision: bf16 weights
and activations, fp32 norms, rotary angles, attention scores, softmax and
online-softmax state, each result cast back to its input's dtype where the
reference casts it.  Attention is the reference's own ``jnp`` algorithm
(dense, or two-level chunks with a causal skip), not a library kernel, so
both packages round the same way.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


# --------------------------------------------------------------------- #
# Configs
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden size
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class XLSTMCfg:
    slstm_every: int = 8  # one sLSTM per this many layers (7:1 mLSTM ratio)
    proj_factor: float = 2.0
    conv_width: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # defaults to d_model // n_heads
    qk_norm: bool = False
    sliding_window: int | None = None
    rope_theta: float = 10_000.0
    moe: MoECfg | None = None
    ssm: SSMCfg | None = None
    xlstm: XLSTMCfg | None = None
    mrope: bool = False  # multimodal 3-axis rotary (qwen2-vl)
    enc_dec: bool = False  # whisper-style encoder-decoder
    n_enc_layers: int = 0
    frontend: str | None = None  # "vision_stub" | "audio_stub"
    frontend_dim: int = 1280  # stub patch/frame feature size
    attn_every: int = 0  # hybrid: one shared attn block per N ssm layers
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- performance knobs of the reference, kept so configs compare equal ---
    q_chunk: int = 1024
    k_chunk: int = 2048
    attn_impl: str = "auto"  # auto | dense | chunked
    remat: str = "full"  # full | none (only matters under a gradient)
    seq_shard_activations: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def num_params(self) -> int:
        """Total parameter count N (for MODEL_FLOPS = 6·N·D accounting)."""
        d, v = self.d_model, self.vocab
        n = v * d  # embed
        if not self.tie_embeddings:
            n += d * v  # lm_head
        per_layer = self._params_per_layer()
        n += self.n_layers * per_layer["default"]
        n += per_layer.get("extra", 0)
        if self.enc_dec:
            n += self.n_enc_layers * per_layer["encoder"]
        if self.frontend:
            n += self.frontend_dim * d  # stub projection
        return n

    def num_active_params(self) -> int:
        """Active parameters per token (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.num_params()
        d, v = self.d_model, self.vocab
        n = v * d + (0 if self.tie_embeddings else d * v)
        attn = self._attn_params()
        expert = 3 * d * self.moe.d_expert
        router = d * self.moe.num_experts
        n += self.n_layers * (attn + 2 * d + router + self.moe.top_k * expert)
        return n

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.hd
        return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d

    def _params_per_layer(self) -> dict[str, int]:
        d = self.d_model
        attn = self._attn_params()
        if self.family == "moe":
            assert self.moe is not None
            ffn = self.moe.num_experts * 3 * d * self.moe.d_expert
            ffn += d * self.moe.num_experts  # router
            return {"default": attn + ffn + 2 * d}
        if self.family == "ssm" and self.xlstm is not None:
            # mLSTM block params (dominant): in/out proj + qkv + gates
            di = int(d * self.xlstm.proj_factor)
            m = 2 * d * di + 3 * di * di // 1 + 2 * di + di  # approx
            return {"default": m + 2 * d}
        if self.family == "hybrid" and self.ssm is not None:
            di = self.ssm.expand * d
            nh = di // self.ssm.head_dim
            mamba = d * (2 * di + 2 * self.ssm.d_state + nh) + di * d + di
            shared_attn = attn + 3 * d * self.d_ff + 2 * d
            return {"default": mamba + 2 * d, "extra": shared_attn}
        if self.enc_dec:
            dec = attn * 2 + 2 * d * self.d_ff + 3 * d  # self+cross attn, GELU mlp
            enc = attn + 2 * d * self.d_ff + 2 * d
            return {"default": dec, "encoder": enc}
        return {"default": attn + 3 * d * self.d_ff + 2 * d}


# --------------------------------------------------------------------- #
# Shape/batch spec per assigned input-shape set
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


# --------------------------------------------------------------------- #
# Primitives
# --------------------------------------------------------------------- #
def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with jnp's dtype promotion (bf16 @ fp32 is an fp32
    product); torch refuses mixed dtypes."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _rope_freqs(half: int, theta: float, device) -> torch.Tensor:
    return torch.exp(-math.log(theta)
                     * torch.arange(0, half, dtype=torch.float32, device=device) / half)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of ``x`` by ``ang`` (fp32, ``(..., S, half)``);
    ``x × fp32`` promotes to fp32 as in jnp, then each half is cast back."""
    half = x.shape[-1] // 2
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype)], dim=-1)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, H, Dh); positions: broadcastable (..., S)."""
    freqs = _rope_freqs(x.shape[-1] // 2, theta, x.device)
    ang = positions[..., None].float() * freqs  # (..., S, half)
    return _rotate(x, ang)


def mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float) -> torch.Tensor:
    """Qwen2-VL M-RoPE: the head dim is split into 3 sections rotated by
    temporal / height / width position ids.  positions3: (3, B, S)."""
    dh = x.shape[-1]
    sec = dh // 2 // 4  # section split 1:1:2 over (t,h,w) quarters of half-dim
    splits = [sec, sec, dh // 2 - 2 * sec]
    freqs = _rope_freqs(dh // 2, theta, x.device)
    parts = []
    lo = 0
    for i, width in enumerate(splits):
        ang = positions3[i][..., None].float() * freqs[lo:lo + width]
        parts.append(ang)
        lo += width
    return _rotate(x, torch.cat(parts, dim=-1))  # (B, S, half)


def swiglu(x, w1, w3, w2):
    """LLaMA-style gated MLP: (silu(x@w1) * (x@w3)) @ w2."""
    h = F.silu(mm(x, w1)) * mm(x, w3)
    return mm(h, w2)


def gelu_mlp(x, w1, b1, w2, b2):
    # jax.nn.gelu defaults to the tanh approximation
    return mm(F.gelu(mm(x, w1) + b1, approximate="tanh"), w2) + b2


# --------------------------------------------------------------------- #
# Memory-efficient attention (online softmax over KV chunks)
# --------------------------------------------------------------------- #
MASKED = -1e30  # the reference's mask value (finite, so exp() never sees -inf - -inf)


def _repeat_kv(k, v, g: int):
    """Expand GQA kv heads to the full head count (``jnp.repeat`` order:
    each kv head ``g`` times in a row)."""
    if g == 1:
        return k, v
    return k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)


def _scores(q, k):
    """fp32 ``bqhd,bkhd->bhqk``: jnp's ``preferred_element_type=float32``
    on bf16 operands (a bf16 product is exact in fp32)."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())


def _mask(qpos, kpos, causal: bool, window: int | None):
    mask = torch.ones((len(qpos), len(kpos)), dtype=torch.bool, device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def _attn_dense(q, k, v, *, causal: bool, window: int | None, q_offset: int = 0):
    """Plain attention; q: (B,Sq,H,Dh), k/v: (B,Sk,Hkv,Dh).  Scores fp32."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    k, v = _repeat_kv(k, v, h // hkv)
    scores = _scores(q, k) * (1.0 / math.sqrt(dh))
    dev = q.device
    mask = _mask(torch.arange(sq, device=dev) + q_offset, torch.arange(sk, device=dev),
                 causal, window)
    scores = torch.where(mask[None, None], scores, MASKED)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, dh)


def _flash_q_chunk(q_blk, kr, vr, qi, qc, kc, causal, window, q_offset, scale):
    """One q chunk against kv chunks ``0 .. kr.shape[1]-1`` (a truncated
    range under the causal skip): running (max, sum, acc) in fp32."""
    b, _, h, dh = q_blk.shape
    dev = q_blk.device
    qpos = qi * qc + torch.arange(qc, device=dev) + q_offset
    m = torch.full((b, h, qc), -math.inf, dtype=torch.float32, device=dev)
    s = torch.zeros((b, h, qc), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, qc, dh), dtype=torch.float32, device=dev)
    for ki in range(kr.shape[1]):
        k_blk, v_blk = kr[:, ki], vr[:, ki]
        scores = _scores(q_blk, k_blk) * scale
        mask = _mask(qpos, ki * kc + torch.arange(kc, device=dev), causal, window)
        scores = torch.where(mask[None, None], scores, MASKED)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        s = s * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk.float())
        m = m_new
    out = acc / torch.clamp(s, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q_blk.dtype)  # (B, qc, H, Dh)


def _attn_chunked(q, k, v, *, causal: bool, window: int | None, q_chunk: int,
                  k_chunk: int, q_offset: int = 0):
    """FlashAttention-style two-level chunking in plain torch: running
    (max, sum, acc) over KV chunks, an outer loop over query chunks.  Never
    materializes the (Sq, Sk) score matrix."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qc = min(q_chunk, sq)
    kc = min(k_chunk, sk)
    n_q, n_k = sq // qc, sk // kc
    assert sq % qc == 0 and sk % kc == 0, (sq, qc, sk, kc)
    scale = 1.0 / math.sqrt(dh)
    k, v = _repeat_kv(k, v, h // hkv)
    kr = k.reshape(b, n_k, kc, h, dh)
    vr = v.reshape(b, n_k, kc, h, dh)
    qs = q.reshape(b, n_q, qc, h, dh)
    skip = causal and window is None and q_offset == 0 and sq == sk and n_q > 1
    outs = []
    for qi in range(n_q):
        # causal skip: q chunk qi only attends to kv chunks covering
        # positions ≤ (qi+1)·qc, so the fully masked upper-triangle chunk
        # pairs are never computed
        n_k_i = min(n_k, -(-(qi + 1) * qc // kc)) if skip else n_k
        outs.append(_flash_q_chunk(qs[:, qi], kr[:, :n_k_i], vr[:, :n_k_i], qi, qc, kc,
                                   causal, window, q_offset, scale))
    return torch.stack(outs, 1).reshape(b, sq, h, dh)


def attention(q, k, v, *, causal=True, window=None, impl="auto", q_chunk=1024,
              k_chunk=2048, q_offset=0):
    """Dispatch between dense and chunked attention."""
    sq, sk = q.shape[1], k.shape[1]
    if impl == "auto":
        impl = "chunked" if (sq > 2048 and sk > 2048) else "dense"
    qc, kc = min(q_chunk, sq), min(k_chunk, sk)
    if impl == "dense" or sq % qc != 0 or sk % kc != 0:
        return _attn_dense(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return _attn_chunked(q, k, v, causal=causal, window=window, q_chunk=qc,
                         k_chunk=kc, q_offset=q_offset)


# --------------------------------------------------------------------- #
# Initialization
# --------------------------------------------------------------------- #
def dense_init(gen: torch.Generator, shape, dtype=torch.bfloat16, scale=None) -> torch.Tensor:
    """N(0, std²) drawn in fp32 from ``gen`` (on ``gen``'s device), then
    cast; std = 1/sqrt(fan_in) unless ``scale`` is given.  The draws are
    torch's, not jax.random's: carry the reference's weights across with
    ``models.convert.lm_params_from_jax``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
            * std).to(dtype)


# the ROADMAP.md queue 1 item that ports each family not yet in the port
NOT_PORTED = {"moe": 9, "vlm": 9, "ssm": 10, "hybrid": 10, "audio": 10}


def not_ported(cfg: ArchConfig) -> NotImplementedError:
    """The error for a config whose family the port does not build yet."""
    return NotImplementedError(
        f"{cfg.name}: the {cfg.family!r} family is not ported yet "
        f"(ROADMAP.md queue 1, item {NOT_PORTED[cfg.family]})")
