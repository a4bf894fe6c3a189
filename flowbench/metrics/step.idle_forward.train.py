"""Percent of the slice in which the device was idle while the train
step's caller was in ``train.inputs``, ``train.forward`` or
``train.loss``: Python issuing the recurrence op by op."""

from flowbench import spans


def read(ctx):
    return spans.idle_in(ctx, ("train.inputs", "train.forward",
                               "train.loss"))
