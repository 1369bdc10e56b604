"""Shared transformer layers: norms, RoPE, GQA/MQA attention, gated FFNs.

The port of the JAX package's ``models/layers.py``.  Functions over plain
dicts of tensors, with the reference's arithmetic order kept where it
rounds: ``sdpa`` scales ``q`` in its own dtype before the float32 upcast and
casts the probabilities to ``v``'s dtype before P·V; norms and RoPE run in
float32 and cast back.  Initializers take a ``torch.Generator``; their bits
differ from ``jax.random``'s, so the CPU tests carry JAX-initialised weights
across (:mod:`.convert`).

Full-sequence attention (prefill) goes through the flash-attention kernel
(:func:`full_attention`); decode attention is :func:`auto_sdpa` over the
cache, as the reference's decode is plain jnp: :func:`sdpa`, or with
:data:`FLASH_DECODE_ENABLED` and a cache of at least
:data:`FLASH_DECODE_THRESHOLD` slots :func:`flash_decode`, the reference's
online softmax over key blocks (plain torch, as the reference's is jnp
outside any Pallas kernel).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels._spmd import pad_zeros  # noqa: F401 (the models' import)
from ..kernels.flash_attention import ops as flash_ops
from ..pjit_utils import mesh_of, shard_index, use_param

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
    (2i, 2i+1) rotates by freq_i, as in the reference.  A DTensor is
    rotated shard by shard (its pairs never straddle two shards of hd)."""
    if mesh_of(x) is not None:
        return _rope_local(x, positions, theta)
    return _rope(x, positions, rope_freqs(x.shape[-1], theta, x.device))


def _rope(x: torch.Tensor, positions: torch.Tensor,
          freqs: torch.Tensor) -> torch.Tensor:
    hd = x.shape[-1]
    ang = positions[..., :, None].float() * freqs              # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xr = x.float().reshape(x.shape[:-1] + (hd // 2, 2))
    x1, x2 = xr[..., 0], xr[..., 1]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def _rope_local(x, positions, theta):
    """RoPE on each rank's shard of a DTensor x (..., S, H, hd): the
    frequencies of the shard's own block of hd (the sequence dim must not
    be split); the layout stays as it is."""
    from torch.distributed.tensor import DTensor
    mesh, nd = x.device_mesh, x.dim()
    if any(pl.is_shard() and pl.dim % nd == nd - 3 for pl in x.placements):
        raise ValueError("RoPE over a split sequence")
    local = x.to_local()
    axes = [i for i, pl in enumerate(x.placements)
            if pl.is_shard() and pl.dim % nd == nd - 1]
    off = shard_index(mesh, axes)
    half = local.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, local.device)[
        off * half:off * half + half]
    if mesh_of(positions) is not None:
        positions = positions.full_tensor()
    return DTensor.from_local(_rope(local, positions, freqs), mesh,
                              x.placements, run_check=False)


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
    y = x @ use_param(p["w"])
    if "b" in p:
        y = y + use_param(p["b"])
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


FLASH_DECODE_THRESHOLD = 8192
FLASH_DECODE_BLOCK = 2048
#: default OFF, as in the reference; the advisor's ``flash_decode`` variant
#: and ``chip_smoke.py`` phase 15 switch it on
FLASH_DECODE_ENABLED = False


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 kv_len: Optional[int] = None,
                 window: Optional[int] = None,
                 attn_softcap: float = 0.0, q_offset: int = 0,
                 scale: Optional[float] = None,
                 block: int = FLASH_DECODE_BLOCK,
                 causal: bool = True) -> torch.Tensor:
    """Single-token decode attention with online softmax over KEY blocks.

    The cache is walked in ``block``-sized slices carrying the running
    (m, l, acc) in float32, so scores never exist at full length.
    q: (B, 1, H, hd); k: (B, Skv, KV, hd); v: (B, Skv, KV, vd).  Masking
    is the reference's: keys at or past ``kv_len`` (default Skv) and, with
    a ``window``, keys with ``q_offset - k_pos >= window`` score -1e30.
    ``causal`` is accepted and ignored, as in the reference (a decode
    query sees every valid key).  Where the reference pads a cache whose
    length is not a multiple of ``block`` with zero keys (masked), the
    port takes a shorter last block; blocks that start at or past
    ``kv_len`` hold only masked keys, which add exactly nothing to
    (l, acc) once a valid key has set m, so they are not read."""
    B, Sq, H, hd = q.shape
    assert Sq == 1
    Skv, KV = k.shape[1], k.shape[2]
    vd = v.shape[3]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    valid = Skv if kv_len is None else int(kv_len)

    qf = (q * scale).float().reshape(B, KV, G, hd)
    m = torch.full((B, KV, G), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, vd), dtype=torch.float32, device=q.device)
    for i0 in range(0, min(valid, Skv), block):
        kb = k.narrow(1, i0, min(block, Skv - i0))
        vb = v.narrow(1, i0, kb.shape[1])
        s = torch.einsum("bkgd,bmkd->bkgm", qf, kb.float())  # (B,KV,G,blk)
        if attn_softcap > 0:
            s = softcap(s, attn_softcap)
        k_pos = i0 + torch.arange(kb.shape[1], device=q.device)
        mask = k_pos < valid
        if window is not None:
            mask &= (q_offset - k_pos) < window
        s = s.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgm,bmkd->bkgd", p.to(v.dtype).float(),
                          vb.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, 1, H, vd).to(q.dtype)


def auto_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              **kw) -> torch.Tensor:
    """The reference's router at the decode call sites: :func:`flash_decode`
    for one query over a cache of at least the threshold when enabled,
    else :func:`sdpa`.  (The reference's third route, ``blockwise_sdpa``
    for long full sequences, is the flash kernel here.)  On DTensors each
    rank attends its own batch rows and heads (:func:`_attend_local`)."""
    if mesh_of(q) is not None:
        return _attend_local(q, k, v, kw)
    return _route(q, k, v, kw)


def _route(q, k, v, kw) -> torch.Tensor:
    if (FLASH_DECODE_ENABLED and q.shape[1] == 1
            and k.shape[1] >= FLASH_DECODE_THRESHOLD):
        return flash_decode(q, k, v, **kw)
    return sdpa(q, k, v, **kw)


def _attend_local(q, k, v, kw) -> torch.Tensor:
    """:func:`auto_sdpa` on DTensors q (B, Sq, H, hd), k and v (B, Skv, KV,
    ·).  Each (batch row, head) attends on its own, so each rank runs the
    plain route on its shards — batch rows as q has them, heads over a
    mesh axis that divides KV — the layout XLA gives the reference's
    einsums, where DTensor, placing the einsums' reshapes one by one, can
    move whole score tensors.  Over the mesh axes that split the cache's
    sequence (batch-1 long context, the ``cache_seq_shard`` variant) each
    rank attends its block of keys and the softmax is combined across the
    blocks (:func:`_attend_seq_split`), flash-decode style."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, KV = q.device_mesh, k.shape[2]
    seq = [i for i, pl in enumerate(k.placements) if pl == Shard(1)]
    layout = [Replicate() if i in seq else Shard(0) if pl == Shard(0) else
              Shard(2) if pl == Shard(2) and KV % size == 0 else Replicate()
              for i, (pl, size) in enumerate(zip(q.placements, mesh.shape))]
    kv_layout = [Shard(1) if i in seq else pl for i, pl in enumerate(layout)]
    ql = q.redistribute(mesh, layout).to_local()
    kl, vl = (t.redistribute(mesh, kv_layout).to_local() for t in (k, v))
    out = (_attend_seq_split(ql, kl, vl, kw, mesh, seq) if seq
           else _route(ql, kl, vl, kw))
    return DTensor.from_local(out, mesh, layout, run_check=False)


def _attend_seq_split(q, k, v, kw, mesh, axes) -> torch.Tensor:
    """Attention of local queries q (B, Sq, H, hd) over this rank's block of
    keys (B, L_loc, KV, ·), combined with the other blocks' over the mesh
    ``axes``: each block's running max m, sum l and P·V acc (float32, the
    masking of :func:`sdpa` at the keys' global positions), then the max
    and the rescaled sums all-reduced.  A block with no valid key adds
    exactly nothing once the max is global."""
    from torch.distributed import _functional_collectives as funcol
    causal, window = kw.get("causal", True), kw.get("window")
    cap, q_offset = kw.get("attn_softcap", 0.0), kw.get("q_offset", 0)
    kv_len, scale = kw.get("kv_len"), kw.get("scale")
    B, Sq, H, hd = q.shape
    Lb, KV, vd = k.shape[1], k.shape[2], v.shape[3]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    off = shard_index(mesh, axes) * Lb
    qf = (q * scale).float().reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgd,bmkd->bkgqm", qf, k.float())
    if cap > 0:
        s = softcap(s, cap)
    q_pos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    k_pos = off + torch.arange(Lb, device=q.device)[None, :]
    mask = torch.ones((Sq, Lb), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    if kv_len is not None:
        mask &= k_pos < kv_len
    s = s.masked_fill(~mask, -1e30)
    m = s.amax(dim=-1)                                     # (B,KV,G,Sq)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqm,bmkd->bkgqd", p.to(v.dtype).float(), v.float())

    def reduce(t, op):
        for i in axes:
            t = funcol.all_reduce(t, op, mesh.get_group(i))
            t = t.wait() if hasattr(t, "wait") else t
        return t
    m_all = reduce(m, "max")
    w = torch.exp(m - m_all)
    l = reduce(l * w, "sum")
    acc = reduce(acc * w[..., None], "sum")
    out = acc / torch.clamp(l, min=1e-30)[..., None]       # (B,KV,G,Sq,vd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, vd).to(q.dtype)


def cache_write(buf: torch.Tensor, start: int, val: torch.Tensor) -> None:
    """``buf[:, start:start + S] = val`` in place (S = val's length).  A
    DTensor cache is written shard by shard: each rank writes the
    positions its block holds, with no collective (DTensor's own slice of
    a cache split along its sequence would gather the whole cache)."""
    val = val.to(buf.dtype)
    if mesh_of(buf) is None:
        buf[:, start:start + val.shape[1]] = val
        return
    local, vl, off = _cache_blocks(buf, val)
    lo, hi = max(start, off), min(start + vl.shape[1], off + local.shape[1])
    if lo < hi:
        local[:, lo - off:hi - off] = vl[:, lo - start:hi - start]


def cache_scatter(buf: torch.Tensor, slots: torch.Tensor,
                  val: torch.Tensor) -> None:
    """``buf.index_copy_(1, slots, val)`` where ``slots`` is a permutation
    of buf's positions (every slot written once: a ring cache's prefill).
    A DTensor cache is written shard by shard, each rank filling its own
    block of positions from the rows that land there."""
    val = val.to(buf.dtype)
    if mesh_of(buf) is None:
        buf.index_copy_(1, slots, val)
        return
    local, vl, off = _cache_blocks(buf, val)
    src = torch.empty_like(slots)
    src[slots] = torch.arange(slots.numel(), device=slots.device)
    local.copy_(vl[:, src[off:off + local.shape[1]]])


def _cache_blocks(buf, val):
    """(buf's local shard, val's laid out as buf's but whole along the
    sequence, the position where this rank's block of buf starts)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = buf.device_mesh
    axes = [i for i, pl in enumerate(buf.placements) if pl == Shard(1)]
    layout = [Replicate() if i in axes else pl
              for i, pl in enumerate(buf.placements)]
    local = buf.to_local()
    vl = val.redistribute(mesh, layout).to_local()
    return local, vl, shard_index(mesh, axes) * local.shape[1]


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
    step) and attention runs over the prefix (:func:`auto_sdpa`).
    """
    q, k, v = project_qkv(p, x, num_heads=num_heads,
                          num_kv_heads=num_kv_heads, head_dim=head_dim,
                          positions=positions, use_rope=use_rope,
                          rope_theta=rope_theta)
    new_cache = None
    if kv_cache is not None:
        S = q.shape[1]
        cache_write(kv_cache["k"], cache_pos, k)
        cache_write(kv_cache["v"], cache_pos, v)
        new_cache = kv_cache
        out = auto_sdpa(q, kv_cache["k"], kv_cache["v"], causal=causal,
                        window=window, attn_softcap=attn_softcap,
                        q_offset=cache_pos, kv_len=cache_pos + S,
                        scale=scale)
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
    table = use_param(p["table"])
    if mesh_of(tokens) is not None:
        rows = _lookup_local(table, tokens)
        if rows is not None:
            return rows
    return table[tokens]


def _lookup_local(table, tokens):
    """A table's rows for DTensor ``tokens``, looked up on each rank's
    shards (vocab-parallel where the table's rows are split: rows outside
    the rank's block are zero and the output is partial over the axes
    that split them); the output is sharded as the tokens are, and the
    table's gradient partial over the axes that split the tokens.  Torch
    versions differ in which of these layouts DTensor's own lookup takes
    (some gather a vocab-split table, some refuse tokens split over two
    axes); None where the layouts do not fit."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    out, grads, vocab = [], [], []
    for i, (tp, kp) in enumerate(zip(table.placements, tokens.placements)):
        if tp == Shard(0) and kp.is_replicate():
            vocab.append(i)
            out.append(Partial())
            grads.append(tp)
        elif tp.is_replicate():
            out.append(kp)
            grads.append(Partial() if kp.is_shard() else Replicate())
        else:
            return None
    local = table.to_local(grad_placements=grads)
    tok = tokens.to_local().long()
    if vocab:
        tok = tok - shard_index(table.device_mesh, vocab) * local.shape[0]
        inside = (tok >= 0) & (tok < local.shape[0])
        rows = local[tok.clamp(0, local.shape[0] - 1)] * \
            inside[..., None].to(local.dtype)
    else:
        rows = local[tok]
    return DTensor.from_local(rows, tokens.device_mesh, out, run_check=False)


def unembed(p: Params, x: torch.Tensor, real_vocab: int,
            cap: float = 0.0) -> torch.Tensor:
    logits = x @ use_param(p["table"]).T
    if cap > 0:
        logits = softcap(logits, cap)
    V = p["table"].shape[0]
    if real_vocab < V:
        pad = torch.arange(V, device=logits.device) >= real_vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL in fp32; logits (B,S,V), labels (B,S).

    On a ``DTensor`` (the vocabulary sharded over "model") it is computed
    vocab-parallel: the max, the sum of exponentials and the gold logit
    (a masked sum) are reductions whose partial results DTensor sums
    across the shards, where ``logsumexp`` and ``gather`` would gather the
    whole (B, S, V) logits, and ``gather``'s backward would allocate them
    unsharded."""
    logits = logits.float()
    if mesh_of(logits) is not None:
        m = logits.amax(dim=-1, keepdim=True).detach()
        logz = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.where(vocab == labels[..., None].long(), logits,
                           0.0).sum(dim=-1)
        return torch.mean(logz - gold)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)
