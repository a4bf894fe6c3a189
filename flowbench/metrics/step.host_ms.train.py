"""The mean duration of the train step on the host (its ``train.step``
span), in ms: the step period when the host bounds it."""

from flowbench import spans


def read(ctx):
    return spans.mean_ms(ctx, "train.step")
