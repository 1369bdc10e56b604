"""flash_fwd_roofline.train: the flash-attention forward's share of its
roofline in the traced training steps (ops ``repro_torch::flash_attention``
and ``::flash_attention_lse``; least time by the frozen cost formulas)."""

from perfbench import trace

OPS = ("repro_torch::flash_attention", "repro_torch::flash_attention_lse")


def read(ctx):
    return trace.roofline(ctx["trace"], OPS)
