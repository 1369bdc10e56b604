"""Reduced configs for CPU smoke tests (same family/structure, tiny dims).

Every assigned arch gets a shrunken sibling: identical pattern/prefix/tail
structure and mixer kinds, but small widths, few experts, tiny vocab — so a
forward/train step runs on one CPU in seconds while exercising the exact
code paths the full config lowers through.
"""

from __future__ import annotations

from dataclasses import replace

from .base import (ArchConfig, EncoderParams, MLAParams, MoEParams,
                   RGLRUParams, SSDParams)


def reduced(cfg: ArchConfig) -> ArchConfig:
    p = len(cfg.pattern)
    # keep prefix + 2 pattern groups + (tail if the arch has one)
    tail = len(cfg.tail_specs)
    num_layers = len(cfg.prefix) + 2 * p + tail

    if cfg.num_kv_heads == cfg.num_heads:
        kv = 4
    elif cfg.num_kv_heads == 1:
        kv = 1
    else:
        kv = 2
    kw = dict(
        num_layers=num_layers, d_model=64, num_heads=4, num_kv_heads=kv,
        head_dim=16, d_ff=0 if cfg.d_ff == 0 else 128, vocab_size=512,
        sliding_window=8, max_learned_pos=128, param_dtype="float32",
        accum_steps=1, opt_state_bf16=False,
    )
    if cfg.moe:
        kw["moe"] = MoEParams(num_experts=8, top_k=min(cfg.moe.top_k, 2),
                              d_ff_expert=64,
                              num_shared=min(cfg.moe.num_shared, 1))
    if cfg.mla:
        kw["mla"] = MLAParams(kv_lora_rank=32, q_lora_rank=48,
                              nope_head_dim=16, rope_head_dim=8,
                              v_head_dim=16)
    if cfg.ssd:
        kw["ssd"] = SSDParams(d_inner=128, state=16, nheads=8,
                              conv_width=4, chunk=16)
    if cfg.rglru:
        kw["rglru"] = RGLRUParams(width=64, conv_width=4)
    if cfg.encoder:
        kw["encoder"] = EncoderParams(num_layers=2, num_frames=16, d_ff=128)
    return replace(cfg, **kw)
