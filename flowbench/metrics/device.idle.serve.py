"""Percent of the slice in which no operation ran on the device."""

from flowbench import trace


def read(ctx):
    return trace.idle(ctx)
