"""What a cell runs: one module a kind of traffic, found by the mix's
``kind`` (``flowbench/kinds/<kind>.py``, through
:func:`flowbench.spec.find`).

Each module has ``run(cell, seed, seconds, traced, device, t_process,
stages) -> dict``: it builds and warms the system under test (set-up,
timed from ``t_process``, with the time at the end of each stage of it
recorded in ``stages``), measures for ``seconds`` (``traced``: profiles a
fixed slice instead), frees the program and holds what the timed path
produced against the reference. The dict it returns holds ``setup_s``,
``attempted``, ``failed``, ``peak_bytes``, ``notes``, ``checks`` (each
compared number with its limit), and ``e2e`` (end-to-end metrics by name;
the run reports those its cell lists) or, traced, ``ctx`` (what the
per-layer metrics' readers read).
"""
