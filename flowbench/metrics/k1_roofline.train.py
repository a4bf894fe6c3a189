"""K1's (the correlation window lookup's) share of its roofline, in percent."""

from flowbench import trace


def read(ctx):
    return trace.roofline(ctx, "k1")
