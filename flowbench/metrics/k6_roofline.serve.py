"""K6's (GMA's attention: q kᵀ and the row softmax) share of its roofline,
in percent, against the HBM bandwidth and the dense TF32 rate."""

from flowbench import counts_gma


def read(ctx):
    return counts_gma.roofline(ctx, "k6")
