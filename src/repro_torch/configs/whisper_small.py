"""whisper-small — enc-dec audio backbone [arXiv:2212.04356; unverified].

12L decoder + 12L encoder, d_model=768, 12H (MHA, kv=12, head_dim=64),
d_ff=3072, vocab=51865.  Conv audio frontend is a STUB: input_specs()
provides precomputed frame embeddings (B, 1500, 768).  Plain (non-gated)
GELU MLP, LayerNorm, learned decoder positions, sinusoidal encoder
positions.  Full attention ⇒ long_500k skipped (DESIGN §4)."""

from .base import ArchConfig, EncoderParams, LayerSpec, register


@register("whisper-small")
def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-small", family="audio",
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
        head_dim=64, d_ff=3072, vocab_size=51865,
        pattern=(LayerSpec(mixer="attn", attn_kind="global",
                           use_rope=False, ffn="dense"),),
        ffn_activation="gelu", ffn_gated=False,
        positional="learned", norm="layernorm",
        encoder=EncoderParams(num_layers=12, num_frames=1500, d_ff=3072),
        frontend="audio", tie_embeddings=True,
        subquadratic=False,
    )
