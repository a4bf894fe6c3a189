"""The one Future-settle idiom for the serving stack, port of
``raft_tpu/serving/futures.py`` (verbatim but for this line).

Every settle in a serving stack races something: the caller's
``cancel()``, a wedge verdict failing the batch from the supervision
loop, a deadline sweep, a no-drain close. ``Future.set_result`` /
``set_exception`` raise ``InvalidStateError`` when the other side of
the race got there first — and an unguarded settle then kills whatever
thread ran it (an ``_expire``-vs-cancel race would take down the
dispatcher from the supervision-loop sweep). The guard is ONE helper
rather than a ``try/except InvalidStateError`` at every site.

Returning whether the settle WON the race is the load-bearing part:
per-future accounting (``submitted == completed + failed +
deadline_missed + cancelled``) stays exact because every site counts
its outcome from the return value instead of double-counting a future
some other path already settled.
"""

from __future__ import annotations

from concurrent.futures import Future, InvalidStateError
from typing import Callable, Optional, Union

#: graftthread: this module defines the one raw-settle site (T2)
GRAFTTHREAD = {"settle_helper": True}


def settle_future(fut: Future,
                  result_or_exc: Union[BaseException, object],
                  raced: Optional[Callable[[], None]] = None) -> bool:
    """Settle ``fut`` with a result, or — when ``result_or_exc`` is an
    exception INSTANCE — fail it. Returns True when this call actually
    settled the future; False when a concurrent settle/cancel won the
    race (``raced``, if given, is invoked exactly then — the hook for
    per-future accounting, e.g. ``metrics.record_cancelled``).

    Never raises ``InvalidStateError``: losing a settle race is a
    counted outcome here, not a thread-killing surprise.
    """
    try:
        if isinstance(result_or_exc, BaseException):
            fut.set_exception(result_or_exc)
        else:
            fut.set_result(result_or_exc)
    except InvalidStateError:
        if raced is not None:
            raced()
        return False
    return True
