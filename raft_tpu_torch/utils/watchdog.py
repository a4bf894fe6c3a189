"""No-progress watchdog, port of ``raft_tpu/utils/watchdog.py``.

A training loop whose device stops completing work blocks with nothing to
catch. A daemon thread watches a heartbeat and, when it goes stale, dumps
every thread's stack and hard-exits the process with
:data:`WEDGED_EXIT_CODE`, so the supervisor (``training.supervisor``)
restarts the run from its newest intact checkpoint.
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time
from typing import Callable, Optional

#: process exit code when the watchdog fires (distinct from crash paths, so
#: the supervisor and runbooks can tell "wedged" from "broken")
WEDGED_EXIT_CODE = 3


class HangWatch:
    """Fire ``on_fire`` (default: stack dump + ``os._exit(3)``) if
    :meth:`beat` has not been called for ``hang_s`` seconds.

    ``hang_s <= 0`` disables it: :meth:`start` returns None and :meth:`beat`
    is a no-op stamp. A beat is one monotonic-clock store.
    """

    def __init__(self, hang_s: float, label: str = "loop",
                 interval: Optional[float] = None,
                 on_fire: Optional[Callable[[float], None]] = None):
        self.hang_s = float(hang_s)
        self.label = label
        if interval is None:
            # the poll follows the deadline: 30 s for a production deadline,
            # a quarter of it for the few seconds a fault drill uses
            interval = (min(30.0, max(0.25, self.hang_s / 4.0))
                        if self.hang_s > 0 else 30.0)
        self.interval = interval
        self._on_fire = on_fire
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        self._last = time.monotonic()

    def stop(self, timeout: float = 2.0) -> None:
        """Disarm and join the watcher (a no-op join from the watcher
        itself, where an ``on_fire`` callback calls it)."""
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout)

    def _fire(self, stale: float) -> None:
        if self._on_fire is not None:
            self._on_fire(stale)
            return
        print(f"[watchdog] {self.label}: no progress for {stale:.0f}s — "
              f"wedged; exiting {WEDGED_EXIT_CODE} so the caller can "
              "restart", file=sys.stderr, flush=True)
        try:
            # every thread's stack, so the report says where the loop
            # stuck: os._exit prints no traceback, and the stuck threads
            # cannot print their own
            faulthandler.dump_traceback(file=sys.stderr)
            sys.stderr.flush()
        except Exception:
            pass  # diagnostics must never block the exit itself
        os._exit(WEDGED_EXIT_CODE)

    def _watch(self) -> None:
        while not self._stop.wait(self.interval):
            stale = time.monotonic() - self._last
            if stale > self.hang_s:
                self._fire(stale)
                return

    def start(self) -> Optional[threading.Thread]:
        if self.hang_s <= 0:
            return None
        self.beat()
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name=f"HangWatch-{self.label}")
        self._thread.start()
        return self._thread
