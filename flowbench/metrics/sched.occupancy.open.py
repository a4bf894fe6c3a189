"""Real pairs over bucket slots of the slice's dispatches, in percent
(``ServingMetrics.snapshot()`` differenced at the slice's ends)."""


def read(ctx):
    return ctx.get("occupancy")
