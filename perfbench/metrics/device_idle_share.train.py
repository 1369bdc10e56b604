"""device_idle_share.train: per cent of the traced training steps' window
in which no device operation ran."""

from perfbench import trace


def read(ctx):
    return trace.idle_share(ctx["trace"])
