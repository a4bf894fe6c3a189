"""What the measuring CLIs (``envelope``, ``infer_bench``, ``corr_bench``,
``profile_step``) share: the device a result ran on, and a time per call.

On the card a time is fenced by CUDA events with the device synchronised
around the calls (PyTorch returns before the card finishes, so a host clock
alone measures the enqueue). On the CPU, which the tests use to drive the
plumbing, it is the host clock; such a number is the CPU's and is labelled
with the device ``"cpu"``.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Optional

import torch


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def nvidia_smi() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card (the line
    every number on the card is written beside), or None without it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def device_info(dev: torch.device) -> dict:
    """The device fields of a CLI's JSON line."""
    if dev.type == "cuda":
        return {"device": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count(),
                "nvidia_smi": nvidia_smi(),
                "torch": torch.__version__, "cuda": torch.version.cuda}
    return {"device": "cpu", "count": 1, "nvidia_smi": None,
            "torch": torch.__version__, "cuda": None}


def elapsed_ms(fn: Callable[[], object], reps: int, dev: torch.device,
               warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` back-to-back calls
    after ``warmup`` calls: CUDA events on the card, the host clock on the
    CPU, the device synchronised before and after."""
    for _ in range(warmup):
        fn()
    sync(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps
