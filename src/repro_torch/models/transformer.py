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
* ``prefill`` — full-sequence forward that also emits the decode cache;
* ``decode``  — single-token step updating the cache (in place).

Ported: the ``attn`` mixer (global, or local with a window over the full
cache) with the flash-attention kernel on the full sequence, the ``mla``
mixer (its latent cache; the kernel on the full sequence through
zero-padded head dims, :mod:`.mla`), the ``ssd`` mixer with the SSD kernel
on the full sequence, ``dense``, ``moe`` (:mod:`.moe`) and ``none`` FFNs,
``rope`` and ``none`` positions.  A config's ``frontend`` is a stub in the
reference too (no model code reads it: the token ids arrive fused).
Anything else raises ``NotImplementedError`` naming ROADMAP Queue 1
item 7.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig, LayerSpec
from . import layers as L
from . import mla as MLA
from . import moe as MOE
from . import ssd as SSD

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_WAITS = "is not ported yet (ROADMAP Queue 1 item 7)"


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a config that needs a mixer or a
    feature the port does not have yet."""
    for spec in cfg.all_specs:
        if spec.mixer not in ("attn", "mla", "ssd"):
            raise NotImplementedError(f"{cfg.name}: mixer '{spec.mixer}' "
                                      f"{_WAITS}")
        if spec.ffn not in ("dense", "moe", "none"):
            raise NotImplementedError(f"{cfg.name}: ffn '{spec.ffn}' {_WAITS}")
        if (spec.mixer == "attn" and spec.attn_kind == "local"
                and cfg.windowed_local_cache):
            raise NotImplementedError(f"{cfg.name}: ring-buffered local "
                                      f"caches {_WAITS}")
    if cfg.encoder is not None:
        raise NotImplementedError(f"{cfg.name}: encoder and cross-attention "
                                  f"{_WAITS}")
    if cfg.positional not in ("rope", "none"):
        raise NotImplementedError(f"{cfg.name}: '{cfg.positional}' positions "
                                  f"{_WAITS}")


# ===========================================================================
# Init
# ===========================================================================

def _init_layer(cfg: ArchConfig, spec: LayerSpec, gen: torch.Generator,
                device) -> Params:
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
    else:
        s = cfg.ssd
        p["attn"] = SSD.ssd_init(gen, cfg.d_model, d_inner=s.d_inner,
                                 state=s.state, nheads=s.nheads,
                                 conv_width=s.conv_width, dtype=dt,
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
    ``device``), with the reference's shapes, scales and dtypes."""
    check_supported(cfg)
    dt = dtype_of(cfg)
    params: Params = {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt, device),
        "final_norm": L.norm_init(cfg.norm, cfg.d_model, dt, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                         dt, device)
    params["layers"] = [_init_layer(cfg, spec, gen, device)
                        for spec in cfg.all_specs]
    return params


# ===========================================================================
# Cache init
# ===========================================================================

def _layer_cache(cfg: ArchConfig, spec: LayerSpec, B: int, Lc: int, dtype,
                 device) -> Dict[str, torch.Tensor]:
    if spec.mixer == "attn":
        kv = (B, Lc, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(kv, dtype=dtype, device=device),
                "v": torch.zeros(kv, dtype=dtype, device=device)}
    if spec.mixer == "mla":
        m = cfg.mla
        shapes = MLA.mla_cache_shape(B, Lc, m.kv_lora_rank, m.rope_head_dim)
        return {k: torch.zeros(shape, dtype=dtype, device=device)
                for k, shape in shapes.items()}
    s = cfg.ssd
    return SSD.ssd_state_init(B, s.d_inner, s.state, s.nheads, s.conv_width,
                              dtype, device)


def init_cache(cfg: ArchConfig, B: int, Lc: int,
               device=None) -> List[Dict[str, torch.Tensor]]:
    """One cache per layer, in execution order: attention → K/V
    (B, Lc, KV, hd); MLA → the latent {"ckv": (B, Lc, R), "krope":
    (B, Lc, rd)}; SSD → recurrent state {"h", "conv"}."""
    check_supported(cfg)
    dt = dtype_of(cfg)
    return [_layer_cache(cfg, spec, B, Lc, dt, device)
            for spec in cfg.all_specs]


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
    s = cfg.ssd
    return SSD.ssd_block(p["attn"], x, d_inner=s.d_inner, state=s.state,
                         nheads=s.nheads, chunk=s.chunk,
                         rec_state=cache if mode == "decode" else None,
                         return_final_state=(mode == "prefill"))


def _attn_prefill(cfg, spec, p, x, positions, cache, window):
    """Full-sequence attention through the flash-attention kernel that also
    fills the decode cache (positions [0, S))."""
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
    S = x.shape[1]
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)
    return y, cache


def _apply_layer(cfg: ArchConfig, spec: LayerSpec, p: Params, x, *,
                 positions, mode: str, cache=None, cache_pos=None):
    """One block.  Returns (x, new_cache, the MoE FFN's aux metrics or
    None)."""
    h = L.norm_apply(cfg.norm, p["ln_attn"], x)
    y, new_cache = _apply_mixer(cfg, spec, p, h, positions=positions,
                                mode=mode, cache=cache, cache_pos=cache_pos)
    if cfg.use_post_norm:
        y = L.norm_apply(cfg.norm, p["ln_attn_post"], y)
    x = x + y
    if spec.ffn == "dense":
        h = L.norm_apply(cfg.norm, p["ln_ffn"], x)
        y = L.ffn(p["ffn"], h, cfg.ffn_activation)
        if cfg.use_post_norm:
            y = L.norm_apply(cfg.norm, p["ln_ffn_post"], y)
        x = x + y
    aux = None
    if spec.ffn == "moe":
        m = cfg.moe
        h = L.norm_apply(cfg.norm, p["ln_ffn"], x)
        y, aux = MOE.moe_ffn(p["ffn"], h, num_experts=m.num_experts,
                             top_k=m.top_k, capacity_factor=m.capacity_factor,
                             activation=cfg.ffn_activation)
        x = x + y
    return x, new_cache, aux


# ===========================================================================
# Full forward passes
# ===========================================================================

def _embed_tokens(cfg, params, tokens):
    x = L.embed(params["embed"], tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _unembed(cfg, params, x):
    x = L.norm_apply(cfg.norm, params["final_norm"], x)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.unembed(table, x, cfg.vocab_size, cfg.logit_softcap)


def _backbone(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
              mode: str, cache: Optional[List], cache_pos: int):
    """(final hidden states, new cache or None, MoE aux): the aux holds
    ``load_balance_loss``, the float32 sum over the MoE layers in execution
    order (0 without any, as the reference's ``aux_total``), and
    ``dropped_frac``, one scalar per MoE layer."""
    check_supported(cfg)
    S = tokens.shape[1]
    start = cache_pos if mode == "decode" else 0
    positions = torch.arange(start, start + S, device=tokens.device)[None, :]
    x = _embed_tokens(cfg, params, tokens)
    new_cache = [] if mode != "train" else None
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    lb = torch.zeros((), dtype=torch.float32, device=tokens.device)
    dropped = []
    for i, spec in enumerate(cfg.all_specs):
        p = params["layers"][i]
        if remat:
            # the layers draw no random numbers: no RNG state to replay
            x, aux = checkpoint(_train_layer, cfg, spec, p, x, positions,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            c = cache[i] if cache is not None else None
            x, nc, aux = _apply_layer(cfg, spec, p, x, positions=positions,
                                      mode=mode, cache=c, cache_pos=cache_pos)
            if new_cache is not None:
                new_cache.append(nc)
        if aux is not None:
            lb = lb + aux["load_balance_loss"]
            dropped.append(aux["dropped_frac"])
    return x, new_cache, {"load_balance_loss": lb, "dropped_frac": dropped}


def _train_layer(cfg: ArchConfig, spec: LayerSpec, p: Params, x, positions):
    x, _, aux = _apply_layer(cfg, spec, p, x, positions=positions,
                             mode="train")
    return x, aux


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
            mode: str = "train", cache: Optional[List] = None,
            cache_pos: int = 0) -> Tuple[torch.Tensor, Optional[List]]:
    """tokens (B, S) → (logits (B, S, V), new cache or None)."""
    x, new_cache, _ = _backbone(cfg, params, tokens, mode, cache, cache_pos)
    return _unembed(cfg, params, x), new_cache


# ===========================================================================
# Public step functions
# ===========================================================================

def loss_fn(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``:
    (B, S)) plus ``cfg.moe.aux_loss_coef`` times the MoE layers' summed
    load-balance loss → (total, {"ce", "moe_aux"}); without MoE layers
    ``moe_aux`` is 0 and total is ce."""
    x, _, aux = _backbone(cfg, params, batch["tokens"], "train", None, 0)
    ce = L.cross_entropy(_unembed(cfg, params, x), batch["labels"])
    moe_aux = aux["load_balance_loss"]
    coef = cfg.moe.aux_loss_coef if cfg.moe else 0.0
    return ce + coef * moe_aux, {"ce": ce, "moe_aux": moe_aux}


def prefill(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
            cache_len: Optional[int] = None, with_aux: bool = False):
    """Serve-prefill: logits for the last position (B, V) + a filled decode
    cache of length ``cache_len`` (default S); ``with_aux`` adds the MoE
    aux of :func:`_backbone` (``dropped_frac`` per MoE layer).  Only the
    last position is unembedded: the reference computes every position's
    logits and keeps the last, and the final norm and unembedding act per
    position, so the result is the same without the (B, S, V) tensor."""
    B, S = tokens.shape
    cache = init_cache(cfg, B, cache_len or S, tokens.device)
    x, new_cache, aux = _backbone(cfg, params, tokens, "prefill", cache, 0)
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
