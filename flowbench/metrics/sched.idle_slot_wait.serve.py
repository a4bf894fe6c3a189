"""Percent of the slice in which the device was idle while the
scheduler's dispatcher waited for a pipeline slot
(``sched.slot_wait``)."""

from flowbench import spans


def read(ctx):
    return spans.idle_in(ctx, ("sched.slot_wait",))
