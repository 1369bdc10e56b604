"""internlm2-1.8b — dense GQA [arXiv:2403.17297; hf].

24L, d_model=2048, 16H (GQA kv=8, head_dim=128), d_ff=8192,
vocab=92544.  Pure full attention ⇒ long_500k skipped."""

from .base import ArchConfig, LayerSpec, register


@register("internlm2-1.8b")
def config() -> ArchConfig:
    return ArchConfig(
        name="internlm2-1.8b", family="dense",
        num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
        head_dim=128, d_ff=8192, vocab_size=92544,
        pattern=(LayerSpec(mixer="attn", attn_kind="global", ffn="dense"),),
        rope_theta=1000000.0, tie_embeddings=False, subquadratic=False,
    )
