"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

The port of the JAX package's ``models/mla.py``.  K and V are compressed
into a low-rank latent ``c_kv`` (kv_lora_rank) plus one RoPE key slice
shared by the heads; the decode cache stores only (c_kv ‖ k_rope) per
token.  Per-head dims follow the paper: nope, rope and v (128, 64 and 128
in deepseek-v2); queries go through their own low-rank projection.

Full-sequence attention (no cache, or a prefill that fills one from
position 0) goes through the flash-attention kernel
(:func:`padded_attention`): the kernel takes one head dim for q, k and v
from ``HEAD_DIMS``, while MLA's q·k runs over nope + rope (192) and its v
has 128, so q and k are zero-padded to the next kernel head dim (256), v
to the same, the scale 1/√(nope + rope) is passed explicitly and the
output is sliced back to v's width.  Zeros add nothing to q·k or to P·V,
so the padding is exact up to the kernel's own rounding.  A prefill
attends over the prompt's own keys; the reference attends over the whole
cache with the keys past the prompt masked, which gives them probability
exactly 0.

Decode — the plain form, which expands the cached latent to K and V, and
the weight-absorbed form (``cfg.mla_absorbed``), which scores against the
latent directly — runs in torch ops over the valid cache prefix, as the
port's attention decode does.  Caches are written in place.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..kernels.flash_attention import ops as flash_ops
from ..pjit_utils import constrain_batch_only, use_param
from .layers import (Params, apply_rope, auto_sdpa, cache_write, dense,
                     dense_init, full_attention, pad_zeros, rmsnorm,
                     rmsnorm_init)


def mla_init(gen: torch.Generator, d_model: int, num_heads: int, *,
             kv_lora_rank: int, q_lora_rank: int, nope_head_dim: int,
             rope_head_dim: int, v_head_dim: int, dtype,
             device=None) -> Params:
    H = num_heads
    return {
        # queries: d_model -> q_lora -> H*(nope+rope)
        "wq_a": dense_init(gen, d_model, q_lora_rank, dtype, device=device),
        "q_norm": rmsnorm_init(q_lora_rank, dtype, device),
        "wq_b": dense_init(gen, q_lora_rank,
                           H * (nope_head_dim + rope_head_dim), dtype,
                           device=device),
        # kv: d_model -> (kv_lora + rope); latent -> H*(nope + v)
        "wkv_a": dense_init(gen, d_model, kv_lora_rank + rope_head_dim,
                            dtype, device=device),
        "kv_norm": rmsnorm_init(kv_lora_rank, dtype, device),
        "wkv_b": dense_init(gen, kv_lora_rank,
                            H * (nope_head_dim + v_head_dim), dtype,
                            device=device),
        "wo": dense_init(gen, H * v_head_dim, d_model, dtype, device=device),
    }


def _project_q(p, x, H, nd, rd, positions, rope_theta):
    q = dense(p["wq_b"], rmsnorm(p["q_norm"], dense(p["wq_a"], x)))
    q = q.reshape(x.shape[:-1] + (H, nd + rd))
    return q[..., :nd], apply_rope(q[..., nd:], positions, rope_theta)


def _project_kv_latent(p, x, kv_lora, rd, positions, rope_theta):
    kv = dense(p["wkv_a"], x)                                   # (B,S,R+rd)
    c_kv = rmsnorm(p["kv_norm"], kv[..., :kv_lora])
    k_rope = apply_rope(kv[..., None, kv_lora:], positions, rope_theta)
    return c_kv, k_rope[..., 0, :]


def _expand_kv(p, c_kv, H, nd, vd):
    kvb = dense(p["wkv_b"], c_kv).reshape(c_kv.shape[:-1] + (H, nd + vd))
    return kvb[..., :nd], kvb[..., nd:]                         # k_nope, v


def padded_head_dim(qk_dim: int, v_dim: int) -> int:
    """The smallest kernel head dim that holds both q·k's and v's widths."""
    return flash_ops.padded_head_dim(max(qk_dim, v_dim))


def padded_attention(q_nope: torch.Tensor, q_rope: torch.Tensor,
                     k_nope: torch.Tensor, k_rope: torch.Tensor,
                     v: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal MLA attention over one sequence through the flash-attention
    kernel (its plain version on CPU tensors).  q_nope, k_nope: (B, S, H,
    nd); q_rope: (B, S, H, rd); k_rope: (B, S, rd), shared by the heads;
    v: (B, S, H, vd) → (B, S, H, vd).  q, k and v are zero-padded to
    (B, S, H, hd), hd from :func:`padded_head_dim` (concatenated and padded,
    not written into a zero buffer, so that a ``DTensor``'s batch and head
    sharding carries through)."""
    B, S, H, nd = q_nope.shape
    rd, vd = q_rope.shape[-1], v.shape[-1]
    hd = padded_head_dim(nd + rd, vd)
    pad = (0, hd - nd - rd)
    q = pad_zeros(torch.cat([q_nope, q_rope], dim=-1), pad)
    k = pad_zeros(torch.cat(
        [k_nope, k_rope[:, :, None, :].expand(B, S, H, rd)], dim=-1), pad)
    vp = pad_zeros(v, (0, hd - vd))
    return full_attention(q, k, vp, causal=True, scale=scale)[..., :vd]


def mla_attention(p: Params, x: torch.Tensor, *, num_heads: int,
                  kv_lora_rank: int, nope_head_dim: int, rope_head_dim: int,
                  v_head_dim: int, rope_theta: float, positions: torch.Tensor,
                  cache: Optional[Dict[str, torch.Tensor]] = None,
                  cache_pos: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, D).  cache = {"ckv": (B, L, R), "krope": (B, L, rd)},
    written at ``cache_pos`` in place.  Without a cache, or at
    ``cache_pos`` 0, attention runs over x's own keys through the kernel;
    past position 0 (decode) over the cache prefix in torch."""
    B, S, D = x.shape
    H, nd, rd, vd, R = (num_heads, nope_head_dim, rope_head_dim,
                        v_head_dim, kv_lora_rank)
    scale = 1.0 / math.sqrt(nd + rd)

    q_nope, q_rope = _project_q(p, x, H, nd, rd, positions, rope_theta)
    c_kv, k_rope = _project_kv_latent(p, x, R, rd, positions, rope_theta)
    if cache is not None:
        cache_write(cache["ckv"], cache_pos, c_kv)
        cache_write(cache["krope"], cache_pos, k_rope)

    if cache is None or not cache_pos:
        k_nope, v = _expand_kv(p, c_kv, H, nd, vd)
        out = padded_attention(q_nope, q_rope, k_nope, k_rope, v, scale)
    else:
        kv_len = cache_pos + S
        k_nope, v = _expand_kv(
            p, constrain_batch_only(cache["ckv"][:, :kv_len]), H, nd, vd)
        krope = cache["krope"][:, :kv_len, None, :]
        k_full = torch.cat([k_nope, krope.expand(k_nope.shape[:-1] + (rd,))],
                           -1)
        out = auto_sdpa(torch.cat([q_nope, q_rope], -1), k_full, v,
                        causal=True, q_offset=cache_pos, kv_len=kv_len,
                        scale=scale)
    y = dense(p["wo"], out.reshape(B, S, H * vd).to(x.dtype))
    return y, cache


def mla_cache_shape(B: int, L: int, kv_lora_rank: int,
                    rope_head_dim: int) -> Dict[str, Tuple[int, ...]]:
    return {"ckv": (B, L, kv_lora_rank), "krope": (B, L, rope_head_dim)}


def mla_attention_absorbed(p: Params, x: torch.Tensor, *, num_heads: int,
                           kv_lora_rank: int, nope_head_dim: int,
                           rope_head_dim: int, v_head_dim: int,
                           rope_theta: float, positions: torch.Tensor,
                           cache: Dict[str, torch.Tensor],
                           cache_pos: int) -> Tuple[torch.Tensor, Dict]:
    """Weight-absorbed MLA decode: scores against the latent cache,
        q_abs = q_nope · W_uk          (B,S,H,R)
        s     = q_abs · c_kvᵀ + q_rope · k_ropeᵀ
        o     = (softmax(s) · c_kv) · W_uv
    in float32 over the valid prefix (the reference masks the rest of the
    cache, which gets probability exactly 0)."""
    B, S, D = x.shape
    H, nd, rd, vd, R = (num_heads, nope_head_dim, rope_head_dim,
                        v_head_dim, kv_lora_rank)
    scale = 1.0 / math.sqrt(nd + rd)

    q_nope, q_rope = _project_q(p, x, H, nd, rd, positions, rope_theta)
    c_kv, k_rope = _project_kv_latent(p, x, R, rd, positions, rope_theta)
    cache_write(cache["ckv"], cache_pos, c_kv)
    cache_write(cache["krope"], cache_pos, k_rope)
    kv_len = cache_pos + S
    ckv = cache["ckv"][:, :kv_len].float()
    krope = cache["krope"][:, :kv_len].float()

    wkv_b = use_param(p["wkv_b"]["w"]).reshape(R, H, nd + vd).float()
    w_uk, w_uv = wkv_b[..., :nd], wkv_b[..., nd:]              # (R,H,nd|vd)

    q_abs = torch.einsum("bqhn,rhn->bqhr", q_nope.float(), w_uk)
    s = (torch.einsum("bqhr,bkr->bhqk", q_abs, ckv)
         + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), krope)) * scale
    k_pos = torch.arange(kv_len, device=x.device)[None, :]
    q_pos = torch.arange(S, device=x.device)[:, None] + cache_pos
    s = s.masked_fill(~(k_pos <= q_pos), -1e30)
    probs = torch.softmax(s, dim=-1)
    o_latent = torch.einsum("bhqk,bkr->bqhr", probs, ckv)
    out = torch.einsum("bqhr,rhv->bqhv", o_latent, w_uv)
    y = dense(p["wo"], out.reshape(B, S, H * vd).to(x.dtype))
    return y, cache
