"""Full-train-state checkpoints, port of ``raft_tpu/training/checkpoint.py``
in torch's format.

Each save holds the whole state a run needs to continue exactly: the model's
parameters and batch-norm buffers, AdamW's moments and step counts, the
OneCycle scheduler, the step, and torch's default generators (CPU and the
model's card). The per-step generator of noise and dropout is seeded from
(seed, step), so the step carries it. Every step goes in its own directory
``<ckpt_dir>/<step>/state.pt`` with a sha256 manifest, written under a
temporary name and renamed into place whole; the newest 20 are kept.

The JAX package reads Orbax steps in a subprocess
(``restore_sandbox.py``) because tensorstore's reader can crash the process
on damaged bytes. The port verifies the manifest before
``torch.load(weights_only=True)`` sees a byte, so a damaged step fails as a
Python error here; the sandbox waits with the supervisor (ROADMAP M8.2).
Saves are synchronous, so there is nothing for the JAX package's
``close_all`` to flush.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

from raft_tpu_torch.tools.convert import (CorruptCheckpointError,
                                          load_verified, save_pth,
                                          save_verified)
from raft_tpu_torch.training.train_step import TrainState
from raft_tpu_torch.utils.ckpt_scan import (STATE_FILE, latest_step_on_disk,
                                            preflight_step, quarantine_path,
                                            step_dirs)

#: step directories kept (Orbax's ``max_to_keep`` in the JAX package)
MAX_TO_KEEP = 20


class StepDamagedError(RuntimeError):
    """A specific step is unreadable: torn, or failing its manifest. The
    only failure the fallback path may quarantine; anything else (disk full,
    a model of another shape) says nothing against the step's bytes."""


def _device(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def _as_tree(state: TrainState) -> dict:
    dev = _device(state)
    rng = {"cpu": torch.get_rng_state()}
    if dev.type == "cuda":
        rng["cuda"] = torch.cuda.get_rng_state(dev)
    return {"step": state.step,
            "model": {k: v.detach().cpu()
                      for k, v in state.model.state_dict().items()},
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(),
            "rng": rng}


def save_train_state(ckpt_dir: str, state: TrainState,
                     step: Optional[int] = None) -> str:
    """Save the full state as step ``step`` (default ``state.step``);
    returns the step directory. Older steps beyond :data:`MAX_TO_KEEP` are
    removed."""
    step = state.step if step is None else int(step)
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, str(step))
    tmp = f"{final}.tmp.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    save_verified(_as_tree(state), os.path.join(tmp, STATE_FILE))
    if os.path.isdir(final):       # a step saved again after a resume
        shutil.rmtree(final)
    os.rename(tmp, final)
    for _, name in step_dirs(ckpt_dir)[MAX_TO_KEEP:]:
        shutil.rmtree(os.path.join(ckpt_dir, name))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    return latest_step_on_disk(os.path.abspath(ckpt_dir))


def _quarantine_step(ckpt_dir: str, step: int) -> Optional[str]:
    """Rename a torn/corrupt step dir aside (``<dir>.corrupt``) so no later
    scan hands it out again; returns the new path. Renames, never deletes."""
    for s, name in step_dirs(ckpt_dir):
        if s == step:
            src = os.path.join(ckpt_dir, name)
            dst = quarantine_path(src)
            os.rename(src, dst)
            return dst
    return None


def _read_step(step_path: str) -> dict:
    reason = preflight_step(step_path)
    if reason is not None:
        raise StepDamagedError(f"{step_path}: {reason}")
    try:
        return load_verified(os.path.join(step_path, STATE_FILE))
    except CorruptCheckpointError as exc:
        raise StepDamagedError(str(exc)) from exc


def _apply(state: TrainState, tree: dict) -> TrainState:
    state.model.load_state_dict(tree["model"], strict=True)
    state.optimizer.load_state_dict(tree["optimizer"])
    state.scheduler.load_state_dict(tree["scheduler"])
    state.step = int(tree["step"])
    torch.set_rng_state(tree["rng"]["cpu"])
    dev = _device(state)
    if dev.type == "cuda" and "cuda" in tree["rng"]:
        torch.cuda.set_rng_state(tree["rng"]["cuda"], dev)
    return state


def restore_train_state(ckpt_dir: str, state: TrainState,
                        step: Optional[int] = None) -> TrainState:
    """Restore into the (freshly created) ``state`` in place and return it.

    With ``step=None`` (the resume path) this restores the newest *intact*
    step: a torn or corrupt newest step is quarantined aside with a logged
    warning and the next-newest tried. A named ``step`` fails loudly
    (:class:`StepDamagedError`, ``FileNotFoundError``): the caller named
    it, so substituting another would be lying.
    """
    path = os.path.abspath(ckpt_dir)
    if step is not None:
        step_path = os.path.join(path, str(step))
        if not os.path.isdir(step_path):
            raise FileNotFoundError(f"no checkpoint step {step} under "
                                    f"{ckpt_dir}")
        return _apply(state, _read_step(step_path))

    skipped = []
    while True:
        dirs = step_dirs(path)
        if not dirs:
            raise FileNotFoundError(
                f"no intact checkpoint under {ckpt_dir}" + (
                    f" (quarantined corrupt step(s): {skipped})"
                    if skipped else ""))
        s, name = dirs[0]
        try:
            tree = _read_step(os.path.join(path, name))
        except StepDamagedError as exc:
            dst = _quarantine_step(path, s)
            skipped.append(s)
            print(f"checkpoint step {s} under {ckpt_dir} is torn/corrupt "
                  f"({exc}); quarantined to {dst or '<step dir not found>'}"
                  " — falling back to the next newest", flush=True)
            continue
        if skipped:
            print(f"resumed from fallback step {s} (skipped corrupt "
                  f"step(s) {skipped})", flush=True)
        return _apply(state, tree)


def save_weights(path: str, model) -> None:
    """Weights-only save (the reference's ``torch.save(state_dict)``): a
    reference-format ``.pth`` with its manifest."""
    save_pth(model, path)
