"""llama4-maverick-400b-a17b — MoE, early fusion
[hf:meta-llama/Llama-4-* family; unverified].

48L, d_model=5120, 40H (GQA kv=8, head_dim=128), d_ff=8192,
vocab=202048, MoE 128 experts top-1 (+1 shared), interleaved every other
layer (Maverick-style).  iRoPE: 3 chunked-local RoPE layers : 1 global
NoPE layer (period 4, lcm with the MoE period).  Chunked-local window
8192 ⇒ sub-quadratic local layers; global layers decode against the full
cache — long_500k runs (decode is per-token linear).  bf16 optimizer
moments so state fits per-chip HBM at 400B."""

from .base import ArchConfig, LayerSpec, MoEParams, register


@register("llama4-maverick-400b-a17b")
def config() -> ArchConfig:
    loc, glob = "local", "global"
    return ArchConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
        head_dim=128, d_ff=8192, vocab_size=202048,
        pattern=(
            LayerSpec(mixer="attn", attn_kind=loc, use_rope=True, ffn="dense"),
            LayerSpec(mixer="attn", attn_kind=loc, use_rope=True, ffn="moe"),
            LayerSpec(mixer="attn", attn_kind=loc, use_rope=True, ffn="dense"),
            LayerSpec(mixer="attn", attn_kind=glob, use_rope=False, ffn="moe"),
        ),
        moe=MoEParams(num_experts=128, top_k=1, d_ff_expert=8192,
                      num_shared=1),
        sliding_window=8192, rope_theta=500000.0,
        frontend="vq",                       # early-fusion stub
        tie_embeddings=False, subquadratic=True,
        opt_state_bf16=True,
        accum_steps=4,
    )
