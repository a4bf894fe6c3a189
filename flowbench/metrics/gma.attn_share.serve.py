"""Percent of the device's busy time in GMA's attention kernels, K6 (the
attention, once a pair) and K7 (the aggregation, every step)."""

from flowbench import counts_gma


def read(ctx):
    return counts_gma.share(ctx)
