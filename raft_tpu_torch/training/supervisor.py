"""Process-level supervision: relaunch training after a wedge, a signal or
a crash. Port of ``raft_tpu/training/supervisor.py``.

``HangWatch`` turns a wedged loop into exit 3 (``WEDGED_EXIT_CODE``). The
supervisor launches the training command as a child process and, on a
retryable death (a wedge, a preemption signal, a crash), relaunches it
after a jittered exponential backoff, relying on ``--resume`` and the
integrity-checked checkpoints to continue from the newest intact step.

Give-up rules (a supervisor must never hot-loop a deterministic crash):

- two consecutive crash-class failures (a plain nonzero exit) whose restore
  point (the newest step on disk) did not advance: the relaunch would
  replay the same step into the same crash. Wedges (exit 3) and signal
  deaths are transient and never trip this rule, and a run with no restore
  point yet has nothing to replay;
- ``max_restarts`` exhausted;
- exit code 2 (usage error) is never retried.

``run()`` returns 0 on eventual success, the child's exit code on give-up,
or ``128 + signum`` when the final child died to a signal.

Operator stop: SIGTERM/SIGINT delivered to the supervisor are forwarded to
the current child, and the supervisor exits ``128 + signum`` after the child
dies instead of restarting it, so a killed supervisor never leaves a trainer
holding the card behind it.

Restart and give-up events are appended to ``metrics_path`` (the trainer's
``metrics.jsonl``). The supervisor imports no torch: it stays a small
parent that a wedged device cannot take down, and its restore-point probe
is a directory scan (``utils.ckpt_scan``).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Callable, Optional, Sequence

from raft_tpu_torch.testing.faults import CRASH_EXIT_CODE
from raft_tpu_torch.utils.ckpt_scan import latest_step_on_disk
from raft_tpu_torch.utils.retry import backoff_delays
from raft_tpu_torch.utils.watchdog import WEDGED_EXIT_CODE

#: usage errors are deterministic; retrying an argparse failure is noise
NON_RETRYABLE_EXIT_CODES = (2,)

#: env var telling the child which supervision attempt it is (0-based);
#: testing.faults scopes drill plan entries to attempts through it
ATTEMPT_ENV = "RAFT_SUPERVISOR_ATTEMPT"

_NO_FAILURE = object()  # distinct from None: "no checkpoint on disk"

#: operator-stop signals the supervisor forwards to the child rather
#: than dying around; SIGINT is in the set for non-tty delivery (a tty
#: ^C already signals the whole foreground group — the forward is then
#: a harmless duplicate)
_FORWARD_SIGNALS = (signal.SIGTERM, signal.SIGINT)


def describe_exit(rc: int) -> str:
    if rc == WEDGED_EXIT_CODE:
        return f"child wedged (exit {rc}, no-progress watchdog)"
    if rc == CRASH_EXIT_CODE:
        return f"child crashed (exit {rc}, injected fault drill)"
    if rc < 0:
        try:
            name = signal.Signals(-rc).name
        except ValueError:
            name = str(-rc)
        return f"child killed by signal {name} (preemption?)"
    return f"child died (exit {rc})"


def exit_class(rc: int) -> str:
    """Coarse label for metrics/alerting: which failure mode was it."""
    if rc == WEDGED_EXIT_CODE:
        return "wedge"
    if rc == CRASH_EXIT_CODE:
        return "crash-drill"
    if rc < 0:
        return "signal"
    return "usage-error" if rc in NON_RETRYABLE_EXIT_CODES else "crash"


class Supervisor:
    """Run ``argv`` as a supervised child until clean exit or give-up.

    ``ckpt_dir`` (the stage dir) enables the restore-point probe behind
    the deterministic-crash rule; pass ``probe_step`` to override it,
    or neither to supervise on ``max_restarts`` alone. ``launch`` and
    ``sleep`` are injectable for tests.

    ``metrics_path``: optional ``metrics.jsonl`` the supervisor appends
    restart events to (attempt, exit class, restored step, backoff) —
    the alerting substrate: a dashboard tailing the trainer's Logger
    records sees the restarts interleaved with the training curves.
    Append-only JSON lines, the Logger's format; a failed append is
    logged and ignored (observability must never take down recovery).
    """

    def __init__(self, argv: Sequence[str], *, max_restarts: int = 5,
                 ckpt_dir: Optional[str] = None,
                 probe_step: Optional[Callable[[], Optional[int]]] = None,
                 base_s: float = 1.0, max_s: float = 60.0,
                 jitter: float = 0.5, rng=None,
                 launch: Optional[Callable[[int, dict], int]] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 metrics_path: Optional[str] = None):
        self.argv = list(argv)
        self.max_restarts = int(max_restarts)
        if probe_step is None and ckpt_dir is not None:
            probe_step = lambda: latest_step_on_disk(ckpt_dir)  # noqa: E731
        self._probe = probe_step
        self._delays = backoff_delays(base_s, max_s, jitter=jitter, rng=rng)
        self._launch = launch if launch is not None else self._spawn
        self._sleep = sleep
        self.restarts = 0
        self._child: Optional[subprocess.Popen] = None
        self._stop_signal: Optional[int] = None
        self._metrics_path = metrics_path

    def _spawn(self, attempt: int, env: dict) -> int:
        proc = subprocess.Popen(self.argv, env=env)
        self._child = proc
        # a stop can land between the loop-top check and the handle
        # assignment above — the handler saw _child=None and had
        # nothing to forward to. Re-check now that the child is
        # visible, or the fresh child would run a full stage inside
        # proc.wait() before the stop took effect
        if self._stop_signal is not None and proc.poll() is None:
            proc.send_signal(self._stop_signal)
        try:
            return proc.wait()
        finally:
            self._child = None

    def _on_signal(self, signum, frame) -> None:
        """SIGTERM/SIGINT handler: forward to the child and remember
        the stop so the wait loop exits instead of restarting."""
        self._stop_signal = signum
        child = self._child
        if child is not None and child.poll() is None:
            child.send_signal(signum)

    def _log(self, msg: str) -> None:
        print(f"[supervisor] {msg}", file=sys.stderr, flush=True)

    def _record(self, event: str, **fields) -> None:
        """Append one event record to metrics.jsonl (Logger format)."""
        if self._metrics_path is None:
            return
        rec = {"event": event, "time": time.time(), **fields}
        try:
            parent = os.path.dirname(self._metrics_path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(self._metrics_path, "a", encoding="utf-8") as fh:
                fh.write(json.dumps(rec) + "\n")
        except OSError as exc:
            self._log(f"metrics append failed ({exc}) — continuing")

    @staticmethod
    def _exit_code(rc: int) -> int:
        """Map a child's raw ``Popen`` code to a sys.exit-able status:
        negative (signal death) becomes the shell's ``128 + signum``
        convention — ``sys.exit(-9)`` would be masked to an undocumented
        247 that matches nothing in the README exit-code table."""
        return 128 - rc if rc < 0 else rc

    def run(self) -> int:
        """Supervise; returns 0 on eventual success, ``128 + signum``
        on an operator stop (SIGTERM/SIGINT forwarded to the child),
        else the final child's exit status via :meth:`_exit_code`
        (callers ``sys.exit`` it — one failure mode, one code, per
        exit-code discipline)."""
        installed = {}
        try:
            for s in _FORWARD_SIGNALS:
                installed[s] = signal.signal(s, self._on_signal)
        except ValueError:
            pass  # not the main thread (embedded/tests): no handlers
        try:
            return self._supervise()
        finally:
            for s, prev in installed.items():
                signal.signal(s, prev)

    def _stopped(self, what: str) -> int:
        name = signal.Signals(self._stop_signal).name
        self._log(f"{name} received — {what}, not restarting")
        return 128 + self._stop_signal

    def _supervise(self) -> int:
        prev_fail_step = _NO_FAILURE
        while True:
            # a stop that landed with no child alive (during backoff,
            # or before the first spawn) had nothing to forward to —
            # honoring it only after one more FULL child run would
            # leave a trainer the operator already killed holding the
            # accelerator claim for hours
            if self._stop_signal is not None:
                return self._stopped("stop requested with no child "
                                     "running")
            env = dict(os.environ)
            env[ATTEMPT_ENV] = str(self.restarts)
            rc = self._launch(self.restarts, env)
            if self._stop_signal is not None:
                outcome = describe_exit(rc) if rc else "child exited clean"
                return self._stopped(f"forwarded to child ({outcome})")
            if rc == 0:
                if self.restarts:
                    self._log(f"child exited clean after "
                              f"{self.restarts} restart(s)")
                    self._record("supervisor_recovered",
                                 restarts=self.restarts)
                return 0
            why = describe_exit(rc)
            if rc in NON_RETRYABLE_EXIT_CODES:
                self._log(f"{why} — usage error, not retrying")
                self._record("supervisor_give_up", reason="usage-error",
                             exit_code=rc, attempt=self.restarts)
                return self._exit_code(rc)
            fail_step = self._probe() if self._probe is not None else None
            # the deterministic-crash rule judges CRASH-class exits
            # only: wedges and signal deaths are transient by
            # definition (and recur at the same step when they strike
            # faster than the checkpoint cadence), and a None probe
            # (no checkpoint yet) has nothing to deterministically
            # replay — both must spend restart budget instead
            crash_class = rc > 0 and rc != WEDGED_EXIT_CODE
            if (crash_class and self._probe is not None
                    and fail_step is not None
                    and prev_fail_step is not _NO_FAILURE
                    and fail_step == prev_fail_step):
                self._log(
                    f"{why} with the restore point still at step "
                    f"{fail_step} — same failure twice with no progress "
                    "is a deterministic crash, giving up")
                self._record("supervisor_give_up",
                             reason="deterministic-crash", exit_code=rc,
                             attempt=self.restarts,
                             restored_step=fail_step)
                return self._exit_code(rc)
            prev_fail_step = fail_step if crash_class else _NO_FAILURE
            if self.restarts >= self.max_restarts:
                self._log(f"{why} — max_restarts={self.max_restarts} "
                          "exhausted, giving up")
                self._record("supervisor_give_up",
                             reason="max-restarts", exit_code=rc,
                             attempt=self.restarts,
                             restored_step=fail_step)
                return self._exit_code(rc)
            self.restarts += 1
            delay = next(self._delays)
            self._log(f"{why} — restart {self.restarts}/"
                      f"{self.max_restarts} (resume point: step "
                      f"{fail_step}) in {delay:.1f}s")
            self._record("supervisor_restart", attempt=self.restarts,
                         exit_code=rc, exit_class=exit_class(rc),
                         restored_step=fail_step,
                         backoff_s=round(delay, 3))
            # sliced so a stop signal cuts the backoff short (PEP 475
            # would otherwise resume a single long sleep to completion
            # and relaunch); the loop-top check turns it into an exit
            remaining = delay
            while remaining > 0 and self._stop_signal is None:
                chunk = min(remaining, 0.5)
                self._sleep(chunk)
                remaining -= chunk
