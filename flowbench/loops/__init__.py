"""How a serving cell offers its requests in time: one module a loop, found
by the traffic mix's ``loop`` (``flowbench/loops/<loop>.py``, through
:func:`flowbench.spec.find`).

Each module has ``offer(load, traffic, seconds, seed) -> (start, end,
notes)``: it sends requests through ``load.send(due, tag)`` (a
:class:`flowbench.kinds.serve.Load`) for a window of ``seconds``, waits
until every request it sent has resolved (``load.events``, one event a
request, carrying its ``tag``), and returns the window's start and end by
``time.perf_counter()`` and a dict of notes for standard error. A loop
reads its own parameters from ``traffic`` and offers the same work on
every seed, in an order the seed may draw.
"""
