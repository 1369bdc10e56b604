"""qwen1.5-110b — dense GQA with QKV bias [hf:Qwen/Qwen1.5 family].

80L, d_model=8192, 64H (GQA kv=8, head_dim=128), d_ff=49152,
vocab=152064, QKV bias, untied embeddings.  Largest dense arch in the
pool — the collective-bound hillclimb target.  Pure full attention ⇒
long_500k skipped."""

from .base import ArchConfig, LayerSpec, register


@register("qwen1.5-110b")
def config() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-110b", family="dense",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=49152, vocab_size=152064,
        pattern=(LayerSpec(mixer="attn", attn_kind="global", ffn="dense"),),
        qkv_bias=True, rope_theta=1000000.0,
        tie_embeddings=False, subquadratic=False,
        opt_state_bf16=True,
        accum_steps=8,
    )
