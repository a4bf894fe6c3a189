"""Read one checkpoint step in a throwaway process; write a verified
snapshot. Port of ``raft_tpu/training/restore_sandbox.py``.

Usage::

    python -m raft_tpu_torch.training.restore_sandbox <step_dir> <out.pt>

The JAX package reads Orbax steps here because tensorstore's reader can
poison the reading process's heap on damaged bytes. ``torch.load`` of bytes
that passed their sha256 manifest does not, but the contract is kept, so a
step that crashes, hangs or fails its read costs a process, not the
trainer:

- the step's ``state.pt`` is read after its manifest passes, with
  ``torch.load(weights_only=True, map_location="cpu")``, and written back
  out as an atomic snapshot with its own manifest (``tools.convert.
  save_verified``); exit 0 with the snapshot on disk is the only success;
- exit :data:`STEP_UNREADABLE_EXIT`: the step cannot be read (torn,
  failing its manifest, unpicklable); the caller quarantines it and falls
  back to an older step;
- exit :data:`ENV_ERROR_EXIT`: the snapshot could not be written (disk
  full, permissions); the step may be intact, so the caller raises and
  quarantines nothing.

``training.checkpoint.restore_train_state`` runs this with
``CUDA_VISIBLE_DEVICES=""`` (the sandbox never claims the card the trainer
holds), without a fault plan, and under the deadline
``$RAFT_RESTORE_TIMEOUT_S``.
"""

from __future__ import annotations

import os
import sys
import traceback

#: the step itself could not be read: the caller may quarantine it
STEP_UNREADABLE_EXIT = 4
#: the snapshot could not be written: an environment failure, not evidence
#: against the step
ENV_ERROR_EXIT = 5


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("usage: restore_sandbox <step_dir> <out.pt>", file=sys.stderr)
        return 2
    step_dir, out_path = argv
    from raft_tpu_torch.tools.convert import load_verified, save_verified
    from raft_tpu_torch.utils.ckpt_scan import STATE_FILE, preflight_step

    try:
        reason = preflight_step(step_dir)
        if reason is not None:
            raise ValueError(reason)
        tree = load_verified(os.path.join(step_dir, STATE_FILE))
    except Exception:
        traceback.print_exc()
        return STEP_UNREADABLE_EXIT
    try:
        save_verified(tree, out_path)
    except Exception:
        traceback.print_exc()
        return ENV_ERROR_EXIT
    return 0


if __name__ == "__main__":
    sys.exit(main())
