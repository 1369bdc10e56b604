"""Architecture config schema + registry.

Every assigned architecture is an :class:`ArchConfig`; the layer stack is a
cyclic ``pattern`` of :class:`LayerSpec`s (period p), scanned over
``num_layers // p`` groups with the remainder unrolled — this keeps compile
time flat in depth while supporting alternating-layer archs (gemma2
local/global, recurrentgemma 2:1 recurrent:attention, llama4 iRoPE+MoE).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Optional, Tuple

_REGISTRY: Dict[str, Callable[[], "ArchConfig"]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> "ArchConfig":
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs():
    return sorted(_REGISTRY)


@dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"          # attn | mla | ssd | rglru
    attn_kind: str = "global"    # global | local
    use_rope: bool = True        # False → NoPE layer (llama4 global layers)
    ffn: str = "dense"           # dense | moe | none


@dataclass(frozen=True)
class MoEParams:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class MLAParams:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    nope_head_dim: int = 128
    rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSDParams:
    d_inner: int
    state: int = 128
    nheads: int = 32
    conv_width: int = 4
    chunk: int = 256


@dataclass(frozen=True)
class RGLRUParams:
    width: int
    conv_width: int = 4


@dataclass(frozen=True)
class EncoderParams:
    num_layers: int
    num_frames: int = 1500       # whisper 30 s @ 50 Hz
    d_ff: int = 3072


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    prefix: Tuple[LayerSpec, ...] = ()     # unrolled layers before the scan
    # attention details
    ffn_activation: str = "silu"
    ffn_gated: bool = True                 # False → plain MLP (whisper)
    qkv_bias: bool = False
    qk_norm: bool = False
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    sliding_window: int = 4096
    rope_theta: float = 10000.0
    attn_scale: Optional[float] = None     # gemma2 query_pre_attn_scalar
    positional: str = "rope"               # rope | learned | none
    max_learned_pos: int = 32768
    # optional sub-configs
    moe: Optional[MoEParams] = None
    mla: Optional[MLAParams] = None
    ssd: Optional[SSDParams] = None
    rglru: Optional[RGLRUParams] = None
    encoder: Optional[EncoderParams] = None
    frontend: str = "none"                 # none | audio | vq
    # misc
    norm: str = "rmsnorm"
    use_post_norm: bool = False            # gemma2 pre+post norms
    tie_embeddings: bool = True
    embed_scale: bool = False              # gemma: × sqrt(d_model)
    param_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"             # full | dots (save matmul outputs)
    mla_absorbed: bool = False             # score in latent space (no K expand)
    subquadratic: bool = False             # supports long_500k
    # training batch/microbatch knobs (overridable per run)
    accum_steps: int = 1
    # optimizer memory: bf16 moments for very large models
    opt_state_bf16: bool = False
    # optimized decode: local layers keep only a window-sized cache
    windowed_local_cache: bool = False

    # -- derived ----------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab_size // 256) * 256

    @property
    def pattern_groups(self) -> int:
        return (self.num_layers - len(self.prefix)) // len(self.pattern)

    @property
    def tail_specs(self) -> Tuple[LayerSpec, ...]:
        r = (self.num_layers - len(self.prefix)) % len(self.pattern)
        return self.pattern[:r]

    @property
    def all_specs(self) -> Tuple[LayerSpec, ...]:
        return (tuple(self.prefix)
                + tuple(self.pattern) * self.pattern_groups
                + tuple(self.tail_specs))

    def param_count(self) -> int:
        """Analytic N (total) — used for 6·N·D roofline checks."""
        D, H, KV, hd, F = (self.d_model, self.num_heads, self.num_kv_heads,
                           self.head_dim, self.d_ff)
        total = self.padded_vocab * D            # embed (tied unembed)
        if not self.tie_embeddings:
            total += self.padded_vocab * D
        for s in self.all_specs:
            if s.mixer == "attn":
                total += D * H * hd + 2 * D * KV * hd + H * hd * D
            elif s.mixer == "mla":
                m = self.mla
                total += (D * m.q_lora_rank
                          + m.q_lora_rank * H * (m.nope_head_dim + m.rope_head_dim)
                          + D * (m.kv_lora_rank + m.rope_head_dim)
                          + m.kv_lora_rank * H * (m.nope_head_dim + m.v_head_dim)
                          + H * m.v_head_dim * D)
            elif s.mixer == "ssd":
                sd = self.ssd
                total += (D * (2 * sd.d_inner + 2 * sd.state + sd.nheads)
                          + sd.d_inner * D)
            elif s.mixer == "rglru":
                r = self.rglru
                total += 2 * D * r.width + 2 * r.width ** 2 + r.width * D
            if s.ffn == "dense":
                total += (3 if self.ffn_gated else 2) * D * F
            elif s.ffn == "moe":
                m = self.moe
                total += m.num_experts * 3 * D * m.d_ff_expert + D * m.num_experts
                if m.num_shared:
                    total += 3 * D * m.d_ff_expert * m.num_shared
        if self.encoder:
            e = self.encoder
            total += e.num_layers * (4 * D * H * hd + 2 * D * e.d_ff)
            # decoder cross-attention
            total += self.num_layers * 4 * D * H * hd
        return total

    def active_param_count(self) -> int:
        """N_active for MoE rooflines (6·N_active·D)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        dense_total = self.param_count()
        n_moe = sum(1 for s in self.all_specs if s.ffn == "moe")
        all_expert = n_moe * m.num_experts * 3 * self.d_model * m.d_ff_expert
        active_expert = n_moe * m.top_k * 3 * self.d_model * m.d_ff_expert
        return dense_total - all_expert + active_expert


# ---------------------------------------------------------------------------
# Input shapes assigned to every LM arch
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shapes_for(cfg: ArchConfig):
    """The (arch × shape) cells this arch runs; long_500k only when
    sub-quadratic (see DESIGN.md §4 skip table)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        names.append("long_500k")
    return [SHAPES[n] for n in names]
