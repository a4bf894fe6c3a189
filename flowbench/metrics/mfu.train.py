"""The whole step's share of the stated precision's peak, in percent:
the algorithm's operations for the pairs finished in the slice over it."""

from flowbench import trace


def read(ctx):
    return trace.mfu(ctx)
