"""ssd_fwd_roofline: the chunked SSD scan's share of its roofline in the
traced training steps (op ``repro_torch::ssd_scan``)."""

from perfbench import trace


def read(ctx):
    return trace.roofline(ctx["trace"], ("repro_torch::ssd_scan",))
