"""Percent of the slice in which the device was idle while the train
step's caller was in ``train.optimizer`` (the clip, AdamW and the
schedule)."""

from flowbench import spans


def read(ctx):
    return spans.idle_in(ctx, ("train.optimizer",))
