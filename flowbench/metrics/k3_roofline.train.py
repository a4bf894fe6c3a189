"""K3's (the lookup's backward's) share of its roofline, in percent."""

from flowbench import trace


def read(ctx):
    return trace.roofline(ctx, "k3")
