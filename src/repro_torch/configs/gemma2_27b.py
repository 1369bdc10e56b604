"""gemma2-27b — dense, local/global alternating, softcaps
[arXiv:2408.00118; hf].

46L, d_model=4608, 32H (GQA kv=16, head_dim=128), d_ff=36864 (GeGLU),
vocab=256000.  Pattern: (local 4096-window, global) alternating; attn
softcap 50, final logit softcap 30; pre+post norms; query scale
1/sqrt(query_pre_attn_scalar=144).  Local layers make decode sub-linear
in cache reads ⇒ long_500k runs (global layers read the full cache)."""

from .base import ArchConfig, LayerSpec, register


@register("gemma2-27b")
def config() -> ArchConfig:
    return ArchConfig(
        name="gemma2-27b", family="dense",
        num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16,
        head_dim=128, d_ff=36864, vocab_size=256000,
        pattern=(LayerSpec(mixer="attn", attn_kind="local", ffn="dense"),
                 LayerSpec(mixer="attn", attn_kind="global", ffn="dense")),
        ffn_activation="gelu", sliding_window=4096,
        attn_softcap=50.0, logit_softcap=30.0,
        attn_scale=144.0 ** -0.5, use_post_norm=True,
        embed_scale=True, tie_embeddings=True,
        subquadratic=True,
        accum_steps=4,
    )
