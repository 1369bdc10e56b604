"""ssd_bwd_roofline: the SSD backward's share of its roofline in the
traced training steps (op ``repro_torch::ssd_scan_backward``)."""

from perfbench import trace


def read(ctx):
    return trace.roofline(ctx["trace"], ("repro_torch::ssd_scan_backward",))
