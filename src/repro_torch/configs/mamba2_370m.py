"""mamba2-370m — attention-free SSM via SSD [arXiv:2405.21060; unverified].

48L, d_model=1024, Mamba-2 blocks only (d_ff=0: no separate FFN),
d_inner=2048, ssm_state=128, 32 heads (headdim 64), conv width 4,
chunk 256, vocab=50280.  No positional encoding; the recurrence carries
position.  State is O(H·P·N) per layer, no KV cache ⇒ long_500k runs.
Lachesis §Arch-applicability: keyed-join partitioning is inapplicable
(attention-free, no dispatch shuffle); data/batch-layout advice applies."""

from .base import ArchConfig, LayerSpec, SSDParams, register


@register("mamba2-370m")
def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-370m", family="ssm",
        num_layers=48, d_model=1024, num_heads=32, num_kv_heads=32,
        head_dim=64, d_ff=0, vocab_size=50280,
        pattern=(LayerSpec(mixer="ssd", ffn="none"),),
        ssd=SSDParams(d_inner=2048, state=128, nheads=32,
                      conv_width=4, chunk=256),
        positional="none", tie_embeddings=True,
        subquadratic=True,
    )
