"""Training logger: running means -> stdout + TensorBoard, the port's own
copy of ``raft_tpu/training/logger.py`` (its ``push_sums`` path: the
trainer sums the metrics on the device and hands over one window at a
time).

Replicates the reference ``Logger`` (train.py:89-133): the means of the
step metrics printed every ``sum_freq`` steps with the step count and the
current learning rate, scalars written to TensorBoard under the same names
(epe/1px/3px/5px/loss). TensorBoard is optional; every record also lands
in ``metrics.jsonl`` next to the event log.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional


class Logger:
    def __init__(self, log_dir: str = "runs",
                 lr_fn: Optional[Callable[[int], float]] = None):
        self.lr_fn = lr_fn
        self.total_steps = 0
        self._t0 = time.perf_counter()
        self._last_steps = 0
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
            self.writer = SummaryWriter(log_dir)
        except Exception:
            self.writer = None

    def _print_status(self, means: Dict[str, float]):
        lr = float(self.lr_fn(self.total_steps)) if self.lr_fn else 0.0
        dt = time.perf_counter() - self._t0
        ips = (self.total_steps - self._last_steps) / max(dt, 1e-9)
        self._t0, self._last_steps = time.perf_counter(), self.total_steps
        # the fixed-width status line of train.py:97-103
        metrics_str = "".join(f"{means[k]:10.4f}, " for k in sorted(means))
        print(f"[{self.total_steps + 1:6d}, {lr:10.7f}] {metrics_str}"
              f"({ips:.2f} steps/s)", flush=True)

    def start_at(self, step: int):
        """Align the step counter (and the steps/s baseline) to ``step``."""
        self.total_steps = step
        self._last_steps = step
        self._t0 = time.perf_counter()

    def push_sums(self, sums: Dict[str, float], n: int):
        """``n`` steps' metric sums at once (the trainer sums on the device
        and fetches once per window): a status line and a record of their
        means, divided by the true count ``n``."""
        if n <= 0:
            return
        self.total_steps += n
        means = {k: float(v) / n for k, v in sums.items()}
        self._print_status(means)
        self.write_dict(means)

    def write_dict(self, results: Dict[str, float]):
        rec = {"step": self.total_steps}
        for k, v in results.items():
            rec[k] = float(v)
            if self.writer is not None:
                self.writer.add_scalar(k, float(v), self.total_steps)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self):
        if self.writer is not None:
            self.writer.close()
        self._jsonl.close()
