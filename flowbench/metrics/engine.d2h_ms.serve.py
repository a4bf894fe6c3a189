"""The mean time a dispatch's outputs take to reach host memory once the
device is done (the engine's ``engine.d2h`` span), in ms."""

from flowbench import spans


def read(ctx):
    return spans.mean_ms(ctx, "engine.d2h")
