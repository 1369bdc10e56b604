"""device_idle_share.serve: per cent of the traced serving calls' window in
which no device operation ran."""

from perfbench import trace


def read(ctx):
    return trace.idle_share(ctx["trace"])
