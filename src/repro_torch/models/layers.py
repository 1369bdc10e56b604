"""Shared transformer layers: norms, RoPE, GQA/MQA attention, gated FFNs.

The port of the JAX package's ``models/layers.py``.  Functions over plain
dicts of tensors, with the reference's arithmetic order kept where it
rounds: ``sdpa`` scales ``q`` in its own dtype before the float32 upcast and
casts the probabilities to ``v``'s dtype before P·V; norms and RoPE run in
float32 and cast back.  Initializers take a ``torch.Generator``; their bits
differ from ``jax.random``'s, so the CPU tests carry JAX-initialised weights
across (:mod:`.convert`).

Full-sequence attention (prefill) goes through the flash-attention kernel
(:func:`full_attention`); decode attention is :func:`sdpa` over the cache,
as the reference's decode is plain jnp.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import ops as flash_ops

Params = Dict[str, Any]


def _randn(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device=None) -> Params:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].float())).to(x.dtype)


def layernorm_init(d: int, dtype, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def norm_init(kind: str, d: int, dtype, device=None) -> Params:
    return (rmsnorm_init(d, dtype, device) if kind == "rmsnorm"
            else layernorm_init(d, dtype, device))


def norm_apply(kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Interleaved (adjacent-pair) RoPE.  x: (..., S, H, hd); pair
    (2i, 2i+1) rotates by freq_i, as in the reference."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # (hd/2,)
    ang = positions[..., :, None].float() * freqs              # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xr = x.float().reshape(x.shape[:-1] + (hd // 2, 2))
    x1, x2 = xr[..., 0], xr[..., 1]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def sinusoidal_embed(length: int, d: int, device=None) -> torch.Tensor:
    """(length, d) float32 positions: sin in the even columns, cos in the
    odd ones (the encoder's)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((length, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# ---------------------------------------------------------------------------
# Dense projections: weights kept (din, dout), as in the reference
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, din: int, dout: int, dtype,
               bias: bool = False, scale: Optional[float] = None,
               device=None) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(din)
    p = {"w": (_randn(gen, (din, dout), device) * scale).to(dtype)}
    if bias:
        p["b"] = torch.zeros((dout,), dtype=dtype, device=device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# Attention (GQA / MQA / MHA, local windows, softcap, NoPE)
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x


def attention_init(gen: torch.Generator, d_model: int, num_heads: int,
                   num_kv_heads: int, head_dim: int, dtype,
                   qkv_bias: bool = False, qk_norm: bool = False,
                   device=None) -> Params:
    p = {
        "wq": dense_init(gen, d_model, num_heads * head_dim, dtype, qkv_bias,
                         device=device),
        "wk": dense_init(gen, d_model, num_kv_heads * head_dim, dtype,
                         qkv_bias, device=device),
        "wv": dense_init(gen, d_model, num_kv_heads * head_dim, dtype,
                         qkv_bias, device=device),
        "wo": dense_init(gen, num_heads * head_dim, d_model, dtype,
                         device=device),
    }
    if qk_norm:
        p["q_norm"] = rmsnorm_init(head_dim, dtype, device)
        p["k_norm"] = rmsnorm_init(head_dim, dtype, device)
    return p


def split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool, window: Optional[int] = None,
         attn_softcap: float = 0.0, q_offset: int = 0,
         kv_len: Optional[int] = None,
         scale: Optional[float] = None) -> torch.Tensor:
    """Scaled dot-product attention with GQA group broadcasting.

    q: (B, Sq, H, hd); k: (B, Skv, KV, hd); v: (B, Skv, KV, vd).
    ``q_offset`` is the absolute position of q[0] (decode: the cache write
    index); ``kv_len`` masks the valid cache prefix.  Keys at or past
    ``kv_len`` get probability exactly 0 in the reference, so they are
    sliced off before the float32 upcast instead of being masked.
    """
    B, Sq, H, hd = q.shape
    if kv_len is not None:
        k, v = k[:, :kv_len], v[:, :kv_len]
    KV, vd = k.shape[2], v.shape[3]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)

    qf = (q * scale).float().reshape(B, Sq, KV, G, hd)          # h = kv·G+g
    scores = torch.einsum("bqkgd,bmkd->bkgqm", qf, k.float())  # B,KV,G,Sq,Skv
    if attn_softcap > 0:
        scores = softcap(scores, attn_softcap)

    Skv = k.shape[1]
    q_pos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    # probabilities in v's dtype × V, float32 accumulation (as the reference)
    out = torch.einsum("bkgqm,bmkd->bqkgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, Sq, H, vd).to(q.dtype)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window: Optional[int] = None,
                   attn_softcap: float = 0.0,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Full-sequence attention through the flash-attention kernel (its plain
    version on CPU tensors).  q: (B, S, H, hd); k/v: (B, S, KV, hd) →
    (B, S, H, hd).  The (B, H, S, hd) views in and out are strided, not
    copied."""
    out = flash_ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=window,
                              softcap=attn_softcap, scale=scale)
    return out.transpose(1, 2)


def project_qkv(p: Params, x: torch.Tensor, *, num_heads: int,
                num_kv_heads: int, head_dim: int, positions: torch.Tensor,
                use_rope: bool, rope_theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) → q (B, S, H, hd), k and v (B, S, KV, hd): projections,
    optional qk-norm, then RoPE on q and k."""
    q = split_heads(dense(p["wq"], x), num_heads, head_dim)
    k = split_heads(dense(p["wk"], x), num_kv_heads, head_dim)
    v = split_heads(dense(p["wv"], x), num_kv_heads, head_dim)
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def attention_block(p: Params, x: torch.Tensor, *, num_heads: int,
                    num_kv_heads: int, head_dim: int,
                    positions: torch.Tensor, use_rope: bool,
                    rope_theta: float, causal: bool = True,
                    window: Optional[int] = None, attn_softcap: float = 0.0,
                    scale: Optional[float] = None,
                    kv_cache: Optional[Dict[str, torch.Tensor]] = None,
                    cache_pos: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self-attention sublayer.

    Without a cache: full-sequence attention (:func:`full_attention`).
    Decode: pass ``kv_cache`` ({"k","v"}: (B, L, KV, hd)) and ``cache_pos``;
    the new k/v are written at ``cache_pos`` IN PLACE (the reference returns
    updated copies; writing in place saves a cache-sized copy per layer and
    step) and attention runs over the prefix.
    """
    q, k, v = project_qkv(p, x, num_heads=num_heads,
                          num_kv_heads=num_kv_heads, head_dim=head_dim,
                          positions=positions, use_rope=use_rope,
                          rope_theta=rope_theta)
    new_cache = None
    if kv_cache is not None:
        S = q.shape[1]
        kv_cache["k"][:, cache_pos:cache_pos + S] = k.to(kv_cache["k"].dtype)
        kv_cache["v"][:, cache_pos:cache_pos + S] = v.to(kv_cache["v"].dtype)
        new_cache = kv_cache
        out = sdpa(q, kv_cache["k"], kv_cache["v"], causal=causal,
                   window=window, attn_softcap=attn_softcap,
                   q_offset=cache_pos, kv_len=cache_pos + S, scale=scale)
    else:
        out = full_attention(q, k, v, causal=causal, window=window,
                             attn_softcap=attn_softcap, scale=scale)
    y = dense(p["wo"], out.reshape(out.shape[:2] + (num_heads * head_dim,)))
    return y, new_cache


# ---------------------------------------------------------------------------
# Gated FFN (SwiGLU / GeGLU) and plain MLP
# ---------------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    """x · sigmoid(x) as two rounded ops, as ``jax.nn.silu``."""
    return x * torch.sigmoid(x)


_ACTIVATIONS = {"silu": silu,
                "gelu": lambda x: F.gelu(x, approximate="tanh"),
                "relu": torch.relu}


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             gated: bool = True, device=None) -> Params:
    p = {"w_in": dense_init(gen, d_model, d_ff, dtype, device=device),
         "w_out": dense_init(gen, d_ff, d_model, dtype, device=device)}
    if gated:
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype, device=device)
    return p


def ffn(p: Params, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    h = dense(p["w_in"], x)
    act = _ACTIVATIONS[activation]
    if "w_gate" in p:
        h = act(dense(p["w_gate"], x)) * h
    else:
        h = act(h)
    return dense(p["w_out"], h)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype,
               device=None) -> Params:
    return {"table": (_randn(gen, (vocab, d_model), device) * 0.02
                      ).to(dtype)}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def unembed(p: Params, x: torch.Tensor, real_vocab: int,
            cap: float = 0.0) -> torch.Tensor:
    logits = x @ p["table"].T
    if cap > 0:
        logits = softcap(logits, cap)
    V = p["table"].shape[0]
    if real_vocab < V:
        pad = torch.arange(V, device=logits.device) >= real_vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL in fp32; logits (B,S,V), labels (B,S)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)
