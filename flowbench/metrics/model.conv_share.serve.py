"""Percent of the device's busy time in convolution kernels."""

from flowbench import trace


def read(ctx):
    return trace.share(ctx, ("conv",))
