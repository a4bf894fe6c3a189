"""The mean ms from being taken into a micro-batch to settling, over the
slice's requests at or above the 95th percentile of their own latency
(``sched.request`` records)."""

from flowbench import spans


def read(ctx):
    split = spans.tail_split(ctx)
    return None if split is None else split[1]
