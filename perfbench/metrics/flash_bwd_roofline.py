"""flash_bwd_roofline: the flash-attention backward's share of its
roofline in the traced training steps (op
``repro_torch::flash_attention_backward``)."""

from perfbench import trace


def read(ctx):
    return trace.roofline(ctx["trace"],
                          ("repro_torch::flash_attention_backward",))
