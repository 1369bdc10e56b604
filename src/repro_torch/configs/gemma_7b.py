"""gemma-7b — dense GeGLU, head_dim=256 [arXiv:2403.08295; hf].

28L, d_model=3072, 16H (kv=16 ⇒ MHA; 2b sibling uses MQA), head_dim=256
(q-dim 4096 > d_model), d_ff=24576 GeGLU, vocab=256000, embeddings
scaled by sqrt(d_model).  Pure full attention ⇒ long_500k skipped."""

from .base import ArchConfig, LayerSpec, register


@register("gemma-7b")
def config() -> ArchConfig:
    return ArchConfig(
        name="gemma-7b", family="dense",
        num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16,
        head_dim=256, d_ff=24576, vocab_size=256000,
        pattern=(LayerSpec(mixer="attn", attn_kind="global", ffn="dense"),),
        ffn_activation="gelu", embed_scale=True, tie_embeddings=True,
        subquadratic=False,
        accum_steps=2,
    )
