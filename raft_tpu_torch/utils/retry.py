"""Exponential backoff with jitter, port of ``raft_tpu/utils/retry.py``.

The shared transient-failure policy: the training supervisor paces its
restarts with :func:`backoff_delays`. Deterministic under test: inject
``rng`` and ``sleep``. The same ``random.Random`` seed yields the same
delays as the JAX package's.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Iterator, Optional, Tuple, Type


def backoff_delays(base_s: float = 0.5, max_s: float = 30.0,
                   factor: float = 2.0, jitter: float = 0.5,
                   rng: Optional[random.Random] = None) -> Iterator[float]:
    """Infinite ``base_s * factor**k`` series capped at ``max_s``, each term
    scaled by a uniform draw in ``[1-jitter, 1+jitter]``: the jitter keeps
    many supervised jobs that died together from restarting in lockstep."""
    if not (0.0 <= jitter <= 1.0):
        raise ValueError(f"jitter={jitter}: must be in [0, 1]")
    rng = random.Random() if rng is None else rng
    delay = min(base_s, max_s)
    while True:
        scale = 1.0 - jitter + 2.0 * jitter * rng.random() if jitter else 1.0
        yield delay * scale
        delay = min(max_s, delay * factor)


def retry(fn: Callable, *, attempts: int = 4, base_s: float = 0.5,
          max_s: float = 30.0, factor: float = 2.0, jitter: float = 0.5,
          retry_on: Tuple[Type[BaseException], ...] = (Exception,),
          on_retry: Optional[Callable[[int, float, BaseException],
                                      None]] = None,
          rng: Optional[random.Random] = None,
          sleep: Optional[Callable[[float], None]] = None):
    """Call ``fn()`` up to ``attempts`` times, sleeping a jittered
    exponential backoff between failures; re-raises the last error.
    ``on_retry(attempt, delay_s, exc)`` is called before each sleep."""
    if attempts < 1:
        raise ValueError(f"attempts={attempts}: must be >= 1")
    if sleep is None:
        sleep = time.sleep  # late-bound: monkeypatchable under test
    delays = backoff_delays(base_s, max_s, factor, jitter, rng)
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except retry_on as exc:
            if attempt == attempts:
                raise
            delay = next(delays)
            if on_retry is not None:
                on_retry(attempt, delay, exc)
            sleep(delay)
