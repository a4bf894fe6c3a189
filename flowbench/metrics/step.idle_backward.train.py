"""Percent of the slice in which the device was idle while the train
step's caller was in ``train.backward`` (the autograd engine)."""

from flowbench import spans


def read(ctx):
    return spans.idle_in(ctx, ("train.backward",))
