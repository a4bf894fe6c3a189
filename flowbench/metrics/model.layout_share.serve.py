"""Percent of the device's busy time in kernels that only rearrange a
tensor's elements: cuDNN's NCHW/NHWC conversions, transposes and copies
into a new layout or dtype."""

from flowbench import trace


def read(ctx):
    return trace.share(ctx, ("layout",))
