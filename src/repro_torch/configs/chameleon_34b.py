"""chameleon-34b — early-fusion VLM [arXiv:2405.09818; unverified].

48L, d_model=8192, 64H (GQA kv=8, head_dim=128), d_ff=22016,
vocab=65536 (text + VQ image codes in one early-fused stream).  QK-norm
(chameleon's stabilization).  The VQ tokenizer is a STUB: input_specs()
provides the fused token ids directly.  Pure full attention ⇒ long_500k
skipped."""

from .base import ArchConfig, LayerSpec, register


@register("chameleon-34b")
def config() -> ArchConfig:
    return ArchConfig(
        name="chameleon-34b", family="vlm",
        num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=22016, vocab_size=65536,
        pattern=(LayerSpec(mixer="attn", attn_kind="global", ffn="dense"),),
        qk_norm=True, frontend="vq",
        tie_embeddings=False, subquadratic=False,
        opt_state_bf16=True,
        accum_steps=4,
    )
