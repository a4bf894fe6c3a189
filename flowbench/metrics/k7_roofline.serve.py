"""K7's (GMA's aggregation: m + γ·(A v)) share of its roofline, in percent,
against the HBM bandwidth and the dense TF32 rate."""

from flowbench import counts_gma


def read(ctx):
    return counts_gma.roofline(ctx, "k7")
