"""flash_fwd_roofline.serve: the flash-attention forward's share of its
roofline in the traced serving calls' prefills (ops
``repro_torch::flash_attention`` and ``::flash_attention_lse``)."""

from perfbench import trace

OPS = ("repro_torch::flash_attention", "repro_torch::flash_attention_lse")


def read(ctx):
    return trace.roofline(ctx["trace"], OPS)
