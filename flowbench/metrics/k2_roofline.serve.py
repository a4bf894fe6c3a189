"""K2's (the GRU gate and blend tails') share of their roofline, in percent."""

from flowbench import trace


def read(ctx):
    return trace.roofline(ctx, "k2")
