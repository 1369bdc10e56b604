"""recurrentgemma-9b — RG-LRU + local attention hybrid (Griffin)
[arXiv:2402.19427; unverified].

38L, d_model=4096, pattern 2 recurrent : 1 local-attention (period 3,
12 groups + 2-layer recurrent tail), 16H MQA (kv=1, head_dim=256) on the
attention layers, d_ff=12288 GeGLU, rglru width 4096, local window 2048,
vocab=256000.  Recurrent state is O(width) and local KV is window-bounded
⇒ long_500k runs natively."""

from .base import ArchConfig, LayerSpec, RGLRUParams, register


@register("recurrentgemma-9b")
def config() -> ArchConfig:
    rec = LayerSpec(mixer="rglru", ffn="dense")
    att = LayerSpec(mixer="attn", attn_kind="local", ffn="dense")
    return ArchConfig(
        name="recurrentgemma-9b", family="hybrid",
        num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
        head_dim=256, d_ff=12288, vocab_size=256000,
        pattern=(rec, rec, att),
        rglru=RGLRUParams(width=4096, conv_width=4),
        ffn_activation="gelu", sliding_window=2048,
        embed_scale=True, tie_embeddings=True,
        subquadratic=True, windowed_local_cache=True,
        accum_steps=4,
    )
