"""Config-driven LM: the port of the JAX package's ``models/transformer.py``
for the mixers and features the serving path of this port runs.

Parameters are plain dicts of tensors.  Where the reference stacks the
pattern slots over groups and ``lax.scan``s them, the port keeps one dict
per layer in ``params["layers"]`` (execution order: prefix, groups × pattern,
tail) and loops over them in Python; caches are a list in the same order.
Three modes share the layer dispatcher:

* ``train``   — full-sequence forward, no caches; with ``cfg.remat`` and
  gradients on, each layer runs under ``torch.utils.checkpoint``
  (non-reentrant) and is recomputed in the backward pass, where the
  reference wraps each scanned group of the pattern in ``jax.checkpoint``
  (the same values; only what is kept between the passes differs);
  ``cfg.remat_policy == "dots"`` keeps the matmul outputs (``mm``,
  ``bmm``, ``addmm``) and recomputes the rest, the reference's
  ``checkpoint_dots`` policy, through selective checkpointing;
* ``prefill`` — full-sequence forward that also emits the decode cache;
* ``decode``  — single-token step updating the cache (in place).

All ten configs run.  Mixers: ``attn`` (global, or local with a window;
with ``cfg.windowed_local_cache`` a local layer keeps a ring-buffered
cache of ``min(Lc, window)`` slots), ``mla`` (its latent cache; the kernel
on the full sequence through zero-padded head dims, :mod:`.mla`), ``ssd``
(the SSD kernel on the full sequence) and ``rglru`` (:mod:`.rglru`: a
log-depth scan in torch, as the reference's is no Pallas kernel).  FFNs
``dense``, ``moe`` (:mod:`.moe`) and ``none``; ``rope``, ``learned`` and
``none`` positions.  An encoder config (whisper) runs its encoder
(non-causal self-attention through the kernel, sinusoidal positions) in
train and prefill, and each decoder layer cross-attends to its output:
through the kernel on the full sequence, torch ``sdpa`` over the cached
cross K/V in decode.  Each decoder layer's cache holds its own cross K/V
(``cache[i]["cross"]``), where the reference stacks them in
``cache["cross"]`` (num_layers, B, F, KV, hd).  A config's ``frontend``
is a stub in the reference too (no model code reads it: the token ids,
and whisper's frame embeddings, arrive fused).

With tracing on (``repro_torch.obs``), every mode records the component
spans ``lm.embed``, ``lm.mixer`` (arg ``kind``), ``lm.ffn``, ``lm.head``
and, in :func:`loss_fn`, ``lm.loss``; under remat the recomputation in
the backward opens them again.  Norms and residual adds outside the
mixer and the FFN belong to no component; the encoder and
cross-attention have no span.  No span synchronizes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig, LayerSpec
from ..obs.tracer import span as _span
from ..pjit_utils import constrain_batch_only, spmd_cache
from . import layers as L
from . import mla as MLA
from . import moe as MOE
from . import rglru as RG
from . import ssd as SSD

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a mixer, FFN or positional kind that no
    config of the reference has."""
    for spec in cfg.all_specs:
        if spec.mixer not in ("attn", "mla", "ssd", "rglru"):
            raise ValueError(f"{cfg.name}: unknown mixer '{spec.mixer}'")
        if spec.ffn not in ("dense", "moe", "none"):
            raise ValueError(f"{cfg.name}: unknown ffn '{spec.ffn}'")
    if cfg.positional not in ("rope", "learned", "none"):
        raise ValueError(f"{cfg.name}: unknown positions '{cfg.positional}'")


_ENC_SPEC = LayerSpec(mixer="attn", attn_kind="global", use_rope=False,
                      ffn="dense")


# ===========================================================================
# Init
# ===========================================================================

def _init_layer(cfg: ArchConfig, spec: LayerSpec, gen: torch.Generator,
                device, cross_attention: bool = False) -> Params:
    dt = dtype_of(cfg)
    p: Params = {"ln_attn": L.norm_init(cfg.norm, cfg.d_model, dt, device)}
    if spec.mixer == "attn":
        p["attn"] = L.attention_init(gen, cfg.d_model, cfg.num_heads,
                                     cfg.num_kv_heads, cfg.head_dim, dt,
                                     qkv_bias=cfg.qkv_bias,
                                     qk_norm=cfg.qk_norm, device=device)
        if cfg.use_post_norm:
            p["ln_attn_post"] = L.norm_init(cfg.norm, cfg.d_model, dt, device)
    elif spec.mixer == "mla":
        m = cfg.mla
        p["attn"] = MLA.mla_init(gen, cfg.d_model, cfg.num_heads,
                                 kv_lora_rank=m.kv_lora_rank,
                                 q_lora_rank=m.q_lora_rank,
                                 nope_head_dim=m.nope_head_dim,
                                 rope_head_dim=m.rope_head_dim,
                                 v_head_dim=m.v_head_dim, dtype=dt,
                                 device=device)
    elif spec.mixer == "ssd":
        s = cfg.ssd
        p["attn"] = SSD.ssd_init(gen, cfg.d_model, d_inner=s.d_inner,
                                 state=s.state, nheads=s.nheads,
                                 conv_width=s.conv_width, dtype=dt,
                                 device=device)
    else:
        r = cfg.rglru
        p["attn"] = RG.rglru_init(gen, cfg.d_model, width=r.width,
                                  conv_width=r.conv_width, dtype=dt,
                                  device=device)
    if cross_attention:
        p["ln_cross"] = L.norm_init(cfg.norm, cfg.d_model, dt, device)
        p["cross"] = L.attention_init(gen, cfg.d_model, cfg.num_heads,
                                      cfg.num_kv_heads, cfg.head_dim, dt,
                                      device=device)
    if spec.ffn == "dense":
        p["ln_ffn"] = L.norm_init(cfg.norm, cfg.d_model, dt, device)
        p["ffn"] = L.ffn_init(gen, cfg.d_model, cfg.d_ff, dt,
                              gated=cfg.ffn_gated, device=device)
        if cfg.use_post_norm:
            p["ln_ffn_post"] = L.norm_init(cfg.norm, cfg.d_model, dt, device)
    elif spec.ffn == "moe":
        m = cfg.moe
        p["ln_ffn"] = L.norm_init(cfg.norm, cfg.d_model, dt, device)
        p["ffn"] = MOE.moe_init(gen, cfg.d_model, m.d_ff_expert,
                                m.num_experts, m.num_shared, dt, device)
    return p


def init_params(cfg: ArchConfig, gen: torch.Generator,
                device=None) -> Params:
    """Random weights drawn from ``gen`` (a ``torch.Generator`` on
    ``device``), with the reference's shapes, scales and dtypes; an encoder
    config adds ``encoder`` = {"layers": [...], "norm"}."""
    check_supported(cfg)
    dt = dtype_of(cfg)
    params: Params = {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt, device),
        "final_norm": L.norm_init(cfg.norm, cfg.d_model, dt, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                         dt, device)
    if cfg.positional == "learned":
        params["pos_embed"] = (torch.randn(
            (cfg.max_learned_pos, cfg.d_model), generator=gen,
            dtype=torch.float32, device=device) * 0.01).to(dt)
    cross = cfg.encoder is not None
    params["layers"] = [_init_layer(cfg, spec, gen, device, cross)
                        for spec in cfg.all_specs]
    if cross:
        params["encoder"] = {
            "layers": [_init_layer(cfg, _ENC_SPEC, gen, device)
                       for _ in range(cfg.encoder.num_layers)],
            "norm": L.norm_init(cfg.norm, cfg.d_model, dt, device)}
    return params


# ===========================================================================
# Cache init
# ===========================================================================

def _ring(cfg: ArchConfig, spec: LayerSpec) -> bool:
    return (spec.mixer == "attn" and spec.attn_kind == "local"
            and cfg.windowed_local_cache)


@dataclass(frozen=True)
class ShapeDtype:
    """A leaf's shape and dtype with no storage (``jax.ShapeDtypeStruct``):
    ``init_cache(..., zeros=ShapeDtype)`` gives the cache's structure."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _layer_cache(cfg: ArchConfig, spec: LayerSpec, B: int, Lc: int,
                 zeros) -> Dict[str, Any]:
    if spec.mixer == "attn":
        length = min(Lc, cfg.sliding_window) if _ring(cfg, spec) else Lc
        kv = (B, length, cfg.num_kv_heads, cfg.head_dim)
        c = {"k": zeros(kv), "v": zeros(kv)}
    elif spec.mixer == "mla":
        m = cfg.mla
        shapes = MLA.mla_cache_shape(B, Lc, m.kv_lora_rank, m.rope_head_dim)
        c = {k: zeros(shape) for k, shape in shapes.items()}
    elif spec.mixer == "ssd":
        s = cfg.ssd
        c = {k: zeros(shape) for k, shape in SSD.ssd_state_shape(
            B, s.d_inner, s.state, s.nheads, s.conv_width).items()}
    else:
        r = cfg.rglru
        c = {k: zeros(shape) for k, shape in RG.rglru_state_shape(
            B, r.width, r.conv_width).items()}
    if cfg.encoder is not None:
        kv = (B, cfg.encoder.num_frames, cfg.num_kv_heads, cfg.head_dim)
        c["cross"] = {"k": zeros(kv), "v": zeros(kv)}
    return c


def init_cache(cfg: ArchConfig, B: int, Lc: int, device=None,
               zeros=None) -> List[Dict[str, Any]]:
    """One cache per layer, in execution order: attention → K/V
    (B, Lc, KV, hd), or (B, min(Lc, window), KV, hd) for a ring-buffered
    local layer; MLA → the latent {"ckv": (B, Lc, R), "krope":
    (B, Lc, rd)}; SSD and RG-LRU → recurrent state {"h", "conv"}; with an
    encoder, each layer's cross K/V {"cross": {"k", "v"}: (B, F, KV, hd)}.
    Each leaf is ``zeros(shape, dtype)``, by default zeros on ``device``."""
    check_supported(cfg)
    dt = dtype_of(cfg)
    if zeros is None:
        zeros = partial(_zeros, device=device)
    return [_layer_cache(cfg, spec, B, Lc, lambda shape: zeros(shape, dt))
            for spec in cfg.all_specs]


def _zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


# ===========================================================================
# Layer application
# ===========================================================================

def _apply_mixer(cfg: ArchConfig, spec: LayerSpec, p: Params, x, *,
                 positions, mode: str, cache, cache_pos):
    """Returns (y, new_cache)."""
    if spec.mixer == "attn":
        window = cfg.sliding_window if spec.attn_kind == "local" else None
        if mode == "prefill":
            return _attn_prefill(cfg, spec, p, x, positions, cache, window)
        if mode == "decode" and _ring(cfg, spec):
            return _attn_decode_ring(cfg, p, x, positions, cache, cache_pos)
        use_rope = cfg.positional == "rope" and spec.use_rope
        return L.attention_block(
            p["attn"], x, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            positions=positions, use_rope=use_rope,
            rope_theta=cfg.rope_theta, window=window,
            attn_softcap=cfg.attn_softcap, scale=cfg.attn_scale,
            kv_cache=cache if mode == "decode" else None,
            cache_pos=cache_pos)
    if spec.mixer == "mla":
        m = cfg.mla
        kw = dict(num_heads=cfg.num_heads, kv_lora_rank=m.kv_lora_rank,
                  nope_head_dim=m.nope_head_dim,
                  rope_head_dim=m.rope_head_dim, v_head_dim=m.v_head_dim,
                  rope_theta=cfg.rope_theta, positions=positions)
        if mode == "decode" and cfg.mla_absorbed:
            return MLA.mla_attention_absorbed(p["attn"], x, cache=cache,
                                              cache_pos=cache_pos, **kw)
        return MLA.mla_attention(p["attn"], x, cache=cache,
                                 cache_pos=cache_pos, **kw)
    if spec.mixer == "ssd":
        s = cfg.ssd
        return SSD.ssd_block(p["attn"], x, d_inner=s.d_inner, state=s.state,
                             nheads=s.nheads, chunk=s.chunk,
                             rec_state=cache if mode == "decode" else None,
                             return_final_state=(mode == "prefill"))
    return RG.rglru_block(p["attn"], x,
                          state=cache if mode == "decode" else None,
                          return_final_state=(mode == "prefill"))


def _attn_prefill(cfg, spec, p, x, positions, cache, window):
    """Full-sequence attention through the flash-attention kernel that also
    fills the decode cache: positions [0, S), or for a ring-buffered local
    layer of W slots with S ≥ W the last W positions at slots ``pos % W``
    (every slot written)."""
    pa = p["attn"]
    q, k, v = L.project_qkv(
        pa, x, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, positions=positions,
        use_rope=cfg.positional == "rope" and spec.use_rope,
        rope_theta=cfg.rope_theta)
    out = L.full_attention(q, k, v, causal=True, window=window,
                           attn_softcap=cfg.attn_softcap, scale=cfg.attn_scale)
    y = L.dense(pa["wo"],
                out.reshape(out.shape[:2] + (cfg.num_heads * cfg.head_dim,)))
    S, W = x.shape[1], cache["k"].shape[1]
    for name, t in (("k", k), ("v", v)):
        if _ring(cfg, spec) and S >= W:
            slots = torch.arange(S - W, S, device=x.device) % W
            L.cache_scatter(cache[name], slots, t[:, S - W:])
        else:
            L.cache_write(cache[name], 0, t)
    return y, cache


def _attn_decode_ring(cfg, p, x, positions, cache, cache_pos):
    """Single-token decode against a ring-buffered local window cache: the
    new k/v go to slot ``cache_pos % W`` (in place), and attention runs
    non-causally, with no window, over the first ``min(cache_pos + 1, W)``
    slots (RoPE was applied before caching, so slot order does not
    matter).  RoPE follows ``cfg.positional`` alone, as in the reference.
    Attention goes through :func:`L.auto_sdpa`, where the reference calls
    ``sdpa``: on the card the decode kernel, which computes the same
    function; elsewhere the two differ only for a ring of at least
    ``FLASH_DECODE_THRESHOLD`` slots with flash decode on, which no config
    has (recurrentgemma-9b, the one config with rings, keeps 2048)."""
    pa = p["attn"]
    q, k, v = L.project_qkv(
        pa, x, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, positions=positions,
        use_rope=cfg.positional == "rope", rope_theta=cfg.rope_theta)
    W = cache["k"].shape[1]
    slot = cache_pos % W
    L.cache_write(cache["k"], slot, k)
    L.cache_write(cache["v"], slot, v)
    out = L.auto_sdpa(q, cache["k"], cache["v"], causal=False,
                      attn_softcap=cfg.attn_softcap, scale=cfg.attn_scale,
                      kv_len=min(cache_pos + 1, W))
    y = L.dense(pa["wo"],
                out.reshape(out.shape[:2] + (cfg.num_heads * cfg.head_dim,)))
    return y, cache


def _cross_attention(cfg: ArchConfig, p: Params, h, mode: str, cross,
                     enc_out):
    """Decoder cross-attention → (y, the cross K/V for the cache).  Train
    and prefill project ``enc_out`` and attend through the kernel; decode
    attends over the cached ``cross`` K/V with :func:`L.sdpa`."""
    pc = p["cross"]
    q = L.split_heads(L.dense(pc["wq"], h), cfg.num_heads, cfg.head_dim)
    if mode == "decode":
        out = L.sdpa(q, cross["k"], cross["v"], causal=False)
    else:
        cross = {w: L.split_heads(L.dense(pc["w" + w], enc_out),
                                  cfg.num_kv_heads, cfg.head_dim)
                 for w in ("k", "v")}
        out = L.full_attention(q, cross["k"], cross["v"], causal=False)
    y = L.dense(pc["wo"],
                out.reshape(out.shape[:2] + (cfg.num_heads * cfg.head_dim,)))
    return y, cross


def _apply_layer(cfg: ArchConfig, spec: LayerSpec, p: Params, x, *,
                 positions, mode: str, cache=None, cache_pos=None,
                 enc_out=None):
    """One block.  Returns (x, new_cache, the MoE FFN's aux metrics or
    None)."""
    h = L.norm_apply(cfg.norm, p["ln_attn"], x)
    with _span("lm.mixer", "lm", kind=spec.mixer):
        y, new_cache = _apply_mixer(cfg, spec, p, h, positions=positions,
                                    mode=mode, cache=cache,
                                    cache_pos=cache_pos)
    if cfg.use_post_norm:
        y = L.norm_apply(cfg.norm, p["ln_attn_post"], y)
    x = constrain_batch_only(x + y)
    if "cross" in p:
        h = L.norm_apply(cfg.norm, p["ln_cross"], x)
        y, cross = _cross_attention(
            cfg, p, h, mode, cache["cross"] if mode == "decode" else None,
            enc_out)
        if mode == "prefill":
            for w in ("k", "v"):
                cache["cross"][w].copy_(cross[w])
        x = constrain_batch_only(x + y)
    if spec.ffn == "dense":
        h = L.norm_apply(cfg.norm, p["ln_ffn"], x)
        with _span("lm.ffn", "lm"):
            y = L.ffn(p["ffn"], h, cfg.ffn_activation)
        if cfg.use_post_norm:
            y = L.norm_apply(cfg.norm, p["ln_ffn_post"], y)
        x = constrain_batch_only(x + y)
    aux = None
    if spec.ffn == "moe":
        m = cfg.moe
        h = L.norm_apply(cfg.norm, p["ln_ffn"], x)
        with _span("lm.ffn", "lm"):
            y, aux = MOE.moe_ffn(p["ffn"], h, num_experts=m.num_experts,
                                 top_k=m.top_k,
                                 capacity_factor=m.capacity_factor,
                                 activation=cfg.ffn_activation)
        x = constrain_batch_only(x + y)
    return x, new_cache, aux


# ===========================================================================
# Full forward passes
# ===========================================================================

#: the ops whose outputs ``remat_policy="dots"`` keeps for the backward
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ArchConfig, fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant; the
    layers draw no random numbers, so no RNG state is replayed), keeping
    the matmul outputs when ``cfg.remat_policy == "dots"``."""
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = partial(create_selective_checkpoint_contexts,
                                   _save_dots)
    elif cfg.remat_policy != "full":
        raise ValueError(f"{cfg.name}: unknown remat_policy "
                         f"'{cfg.remat_policy}'")
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def _encoder_layer(cfg: ArchConfig, p: Params, h, positions):
    hn = L.norm_apply(cfg.norm, p["ln_attn"], h)
    y, _ = L.attention_block(p["attn"], hn, num_heads=cfg.num_heads,
                             num_kv_heads=cfg.num_kv_heads,
                             head_dim=cfg.head_dim, positions=positions,
                             use_rope=False, rope_theta=cfg.rope_theta,
                             causal=False)
    h = h + y
    hn = L.norm_apply(cfg.norm, p["ln_ffn"], h)
    return h + L.ffn(p["ffn"], hn, cfg.ffn_activation)


def _encoder_forward(cfg: ArchConfig, params: Params, frames: torch.Tensor,
                     remat: bool) -> torch.Tensor:
    """frames (B, F, D) → the encoder's output (B, F, D): float32
    sinusoidal positions cast to the param dtype, non-causal
    self-attention layers (through the kernel), a final norm."""
    F = cfg.encoder.num_frames
    x = frames.to(dtype_of(cfg))
    x = x + L.sinusoidal_embed(F, cfg.d_model, x.device).to(x.dtype)
    positions = torch.arange(F, device=x.device)
    for p in params["encoder"]["layers"]:
        if remat:
            x = _remat(cfg, _encoder_layer, cfg, p, x, positions)
        else:
            x = _encoder_layer(cfg, p, x, positions)
    return L.norm_apply(cfg.norm, params["encoder"]["norm"], x)


def _embed_tokens(cfg, params, tokens):
    with _span("lm.embed", "lm"):
        x = L.embed(params["embed"], tokens)
        if cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
        return x


def _unembed(cfg, params, x):
    with _span("lm.head", "lm"):
        x = L.norm_apply(cfg.norm, params["final_norm"], x)
        table = params["embed"] if cfg.tie_embeddings else params["unembed"]
        return L.unembed(table, x, cfg.vocab_size, cfg.logit_softcap)


def _backbone(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
              mode: str, cache: Optional[List], cache_pos: int,
              frames: Optional[torch.Tensor] = None):
    """(final hidden states, new cache or None, MoE aux): the aux holds
    ``load_balance_loss``, the float32 sum over the MoE layers in execution
    order (0 without any, as the reference's ``aux_total``), and
    ``dropped_frac``, one scalar per MoE layer.  An encoder config needs
    ``frames`` (B, F, D) in train and prefill; decode reads the cached
    cross K/V."""
    check_supported(cfg)
    S = tokens.shape[1]
    start = cache_pos if mode == "decode" else 0
    positions = torch.arange(start, start + S, device=tokens.device)[None, :]
    x = _embed_tokens(cfg, params, tokens)
    if cfg.positional == "learned":
        x = x + params["pos_embed"][start:start + S].to(x.dtype)
    x = constrain_batch_only(x)
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    enc_out = None
    if cfg.encoder is not None and mode != "decode":
        if frames is None:
            raise ValueError(f"{cfg.name}: the encoder needs frames "
                             f"(B, {cfg.encoder.num_frames}, {cfg.d_model})")
        enc_out = _encoder_forward(cfg, params, frames, remat)
    new_cache = [] if mode != "train" else None
    lb = torch.zeros((), dtype=torch.float32, device=tokens.device)
    dropped = []
    for i, spec in enumerate(cfg.all_specs):
        p = params["layers"][i]
        if remat:
            x, aux = _remat(cfg, _train_layer, cfg, spec, p, x, positions,
                            enc_out)
        else:
            c = cache[i] if cache is not None else None
            x, nc, aux = _apply_layer(cfg, spec, p, x, positions=positions,
                                      mode=mode, cache=c, cache_pos=cache_pos,
                                      enc_out=enc_out)
            if new_cache is not None:
                new_cache.append(nc)
        if aux is not None:
            lb = lb + aux["load_balance_loss"]
            dropped.append(aux["dropped_frac"])
    return x, new_cache, {"load_balance_loss": lb, "dropped_frac": dropped}


def _train_layer(cfg: ArchConfig, spec: LayerSpec, p: Params, x, positions,
                 enc_out):
    x, _, aux = _apply_layer(cfg, spec, p, x, positions=positions,
                             mode="train", enc_out=enc_out)
    return x, aux


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
            frames: Optional[torch.Tensor] = None, mode: str = "train",
            cache: Optional[List] = None,
            cache_pos: int = 0) -> Tuple[torch.Tensor, Optional[List]]:
    """tokens (B, S) → (logits (B, S, V), new cache or None)."""
    x, new_cache, _ = _backbone(cfg, params, tokens, mode, cache, cache_pos,
                                frames)
    return _unembed(cfg, params, x), new_cache


# ===========================================================================
# Public step functions
# ===========================================================================

def loss_fn(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``:
    (B, S); ``frames`` (B, F, D) for an encoder config) plus
    ``cfg.moe.aux_loss_coef`` times the MoE layers' summed load-balance
    loss → (total, {"ce", "moe_aux"}); without MoE layers ``moe_aux`` is 0
    and total is ce."""
    x, _, aux = _backbone(cfg, params, batch["tokens"], "train", None, 0,
                          batch.get("frames"))
    logits = _unembed(cfg, params, x)
    with _span("lm.loss", "lm"):
        ce = L.cross_entropy(logits, batch["labels"])
    moe_aux = aux["load_balance_loss"]
    coef = cfg.moe.aux_loss_coef if cfg.moe else 0.0
    return ce + coef * moe_aux, {"ce": ce, "moe_aux": moe_aux}


def prefill(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
            frames: Optional[torch.Tensor] = None,
            cache_len: Optional[int] = None, with_aux: bool = False):
    """Serve-prefill: logits for the last position (B, V) + a filled decode
    cache of length ``cache_len`` (default S); ``frames`` for an encoder
    config; ``with_aux`` adds the MoE aux of :func:`_backbone`
    (``dropped_frac`` per MoE layer).  Only the last position is
    unembedded: the reference computes every position's logits and keeps
    the last, and the final norm and unembedding act per position, so the
    result is the same without the (B, S, V) tensor."""
    B, S = tokens.shape
    cache = spmd_cache(cfg, B, cache_len or S, tokens)
    x, new_cache, aux = _backbone(cfg, params, tokens, "prefill", cache, 0,
                                  frames)
    logits = _unembed(cfg, params, x[:, -1:])[:, -1]
    return (logits, new_cache, aux) if with_aux else (logits, new_cache)


def decode_step(cfg: ArchConfig, params: Params, cache: List,
                tokens: torch.Tensor, pos: int):
    """One decode step: tokens (B,1), ``pos`` the next write index (an
    int).  Attention caches are updated in place; the returned cache is the
    one to pass to the next step."""
    logits, new_cache = forward(cfg, params, tokens, mode="decode",
                                cache=cache, cache_pos=int(pos))
    return logits[:, -1], new_cache
