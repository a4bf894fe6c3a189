"""Percent of the slice in which the device was idle while the
scheduler's dispatcher gathered, assembled or shipped a micro-batch
(``sched.gather``, ``sched.assemble``, ``sched.ship``)."""

from flowbench import spans


def read(ctx):
    return spans.idle_in(ctx, ("sched.gather", "sched.assemble",
                               "sched.ship"))
