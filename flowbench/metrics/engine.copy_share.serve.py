"""Percent of the device's busy time in memcpy and memset operations
(frames in, clones, flows out)."""

from flowbench import trace


def read(ctx):
    return trace.share(ctx, ("copy",))
