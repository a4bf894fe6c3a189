"""Filesystem-truth scan of a checkpoint directory's step directories, port
of ``raft_tpu/utils/ckpt_scan.py``.

One notion of "which steps exist on disk" for the trainer's resume and the
checkpoint fallback path, read from ``listdir`` each time. A step directory
of the port (``training.checkpoint``) holds ``state.pt`` and its sha256
manifest ``state.pt.sha256``; it is written under a temporary name and
renamed into place whole.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

#: suffix that damaged artifacts are renamed to; scans skip anything with it
QUARANTINE_SUFFIX = ".corrupt"

#: the full train state inside a step directory, beside its manifest
STATE_FILE = "state.pt"

# step-dir names: "120", "step_120", "checkpoint-120"
_STEP_DIR_RE = re.compile(r"^[A-Za-z_\-]*?(\d+)$")


def quarantine_path(src: str) -> str:
    """First collision-free ``<src>.corrupt[.N]`` destination for renaming
    a damaged artifact aside (step dirs, stage finals): renamed, never
    deleted, so the bytes stay for forensics."""
    dst = src + QUARANTINE_SUFFIX
    i = 0
    while os.path.exists(dst):
        i += 1
        dst = f"{src}{QUARANTINE_SUFFIX}.{i}"
    return dst


def step_dirs(ckpt_dir: str) -> List[Tuple[int, str]]:
    """``(step, dirname)`` for every committed-looking step dir under
    ``ckpt_dir``, newest first; quarantined and in-flight tmp dirs are
    excluded."""
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return []
    out = []
    for name in names:
        if QUARANTINE_SUFFIX in name or "tmp" in name.lower():
            continue
        m = _STEP_DIR_RE.match(name)
        if m and os.path.isdir(os.path.join(ckpt_dir, name)):
            out.append((int(m.group(1)), name))
    return sorted(out, reverse=True)


def preflight_step(step_path: str) -> Optional[str]:
    """Cheap integrity probe of one step dir before anything unpickles it:
    the state file and its manifest must exist and the manifest must parse
    as ``<64 hex digits>  <size>`` with the file's size. Returns None when
    the step looks intact, else a short reason. Damage that keeps the size
    is caught by the sha256 check at restore."""
    state = os.path.join(step_path, STATE_FILE)
    try:
        with open(state + ".sha256", encoding="utf-8") as fh:
            fields = fh.read().split()
        size = os.path.getsize(state)
    except OSError as exc:
        return f"{type(exc).__name__}: {exc} (torn or uncommitted save)"
    if (len(fields) != 2 or not re.fullmatch(r"[0-9a-f]{64}", fields[0])
            or not fields[1].isdigit()):
        return f"unparsable manifest {fields!r}"
    if int(fields[1]) != size:
        return f"{STATE_FILE} has {size} bytes, its manifest {fields[1]}"
    return None


def latest_step_on_disk(ckpt_dir: str) -> Optional[int]:
    """Newest on-disk step, or None."""
    dirs = step_dirs(ckpt_dir)
    return dirs[0][0] if dirs else None
