"""deepseek-v2-236b — MoE with Multi-head Latent Attention
[arXiv:2405.04434; hf].

60L, d_model=5120, 128H MLA (kv_lora_rank=512, q_lora=1536, nope=128,
rope=64, v=128), vocab=102400.  First layer dense FFN d_ff=12288; the
remaining 59 layers are MoE: 160 routed experts top-6 (d_ff_expert=1536)
+ 2 shared experts.  Full attention ⇒ long_500k skipped; the MLA
compressed KV cache (512+64 per token vs 2·128·128) is the decode story."""

from .base import ArchConfig, LayerSpec, MLAParams, MoEParams, register


@register("deepseek-v2-236b")
def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-236b", family="moe",
        num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
        head_dim=128, d_ff=12288, vocab_size=102400,
        prefix=(LayerSpec(mixer="mla", ffn="dense"),),
        pattern=(LayerSpec(mixer="mla", ffn="moe"),),
        mla=MLAParams(kv_lora_rank=512, q_lora_rank=1536,
                      nope_head_dim=128, rope_head_dim=64, v_head_dim=128),
        moe=MoEParams(num_experts=160, top_k=6, d_ff_expert=1536,
                      num_shared=2),
        tie_embeddings=False, subquadratic=False,
        opt_state_bf16=True,
        accum_steps=4,
    )
