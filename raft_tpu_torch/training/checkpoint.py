"""Full-train-state checkpoints, port of ``raft_tpu/training/checkpoint.py``
in torch's format.

Each save holds the whole state a run needs to continue exactly: the model's
parameters and batch-norm buffers, AdamW's moments and step counts, the
OneCycle scheduler, the step, and torch's default generators (CPU and the
model's card). The per-step generator of noise and dropout is seeded from
(seed, step), so the step carries it. Every step goes in its own directory
``<ckpt_dir>/<step>/state.pt`` with a sha256 manifest, written under a
temporary name and renamed into place whole; the newest 20 are kept.

A step is read the way the JAX package reads an Orbax step: in a throwaway
process (``training.restore_sandbox``) that checks the manifest, runs
``torch.load(weights_only=True)`` and writes a verified snapshot, which
this process then loads. The sandbox's exit code decides what a failure
means: the step is damaged (quarantine it and fall back to an older one)
or the environment failed (raise, quarantine nothing). Saves are
synchronous, so there is nothing for the JAX package's ``close_all`` to
flush.
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import sys
from typing import Optional

import torch

from raft_tpu_torch.testing import faults
from raft_tpu_torch.tools.convert import (load_verified, manifest_path,
                                          save_pth, save_verified)
from raft_tpu_torch.training.restore_sandbox import STEP_UNREADABLE_EXIT
from raft_tpu_torch.training.train_step import TrainState
from raft_tpu_torch.utils.ckpt_scan import (STATE_FILE, latest_step_on_disk,
                                            preflight_step, quarantine_path,
                                            step_dirs)

#: step directories kept (Orbax's ``max_to_keep`` in the JAX package)
MAX_TO_KEEP = 20


class StepDamagedError(RuntimeError):
    """A specific step is unreadable: torn, failing its manifest, or
    crashing or hanging the process that reads it. The only failure the
    fallback path may quarantine; anything else (disk full, a model of
    another shape, the sandbox killed from outside) says nothing against the
    step's bytes."""


#: sandbox deaths that indict the step: the crash signals a damaged input
#: can provoke in a reader. SIGKILL and SIGTERM are left out: the OOM killer
#: and process managers send them for reasons that say nothing about the
#: step, and quarantining on them would shred an intact history.
_CRASH_SIGNALS = frozenset(int(s) for s in (
    signal.SIGSEGV, signal.SIGABRT, signal.SIGBUS, signal.SIGILL,
    signal.SIGFPE))

#: seconds one sandbox read may take (0 disables); a read that hangs past
#: it is treated as a damaged step. It runs before the trainer's watchdog
#: is armed, so without it a hung read would wedge resume for good.
_SANDBOX_TIMEOUT_ENV = "RAFT_RESTORE_TIMEOUT_S"
_SANDBOX_TIMEOUT_DEFAULT_S = 900.0

#: the directory that holds the package, so the sandbox finds it from any
#: working directory
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


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
    if faults.armed("ckpt.orbax_save"):
        # drills: damage the committed step (what the restore must catch),
        # or die right after it
        victim = faults.fault_file("ckpt.orbax_save", final)
        if victim:
            print(f"[faults] corrupted {victim}", flush=True)
        faults.fault_point("ckpt.orbax_save")
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


def _sandbox_env() -> dict:
    env = dict(os.environ)
    # drills target the trainer's own sites, not the sandbox's writes
    env.pop("RAFT_FAULT_PLAN", None)
    env.pop("RAFT_FAULT_PLAN_FILE", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_PKG_ROOT, env.get("PYTHONPATH")) if p)
    return env


def _read_step(step_path: str) -> dict:
    """The state tree of one step, read through the restore sandbox.
    Raises :class:`StepDamagedError` for a step that is torn, fails its
    manifest, crashes its reader or hangs past the deadline, and
    ``RuntimeError`` for any other failure of the sandbox."""
    reason = preflight_step(step_path)
    if reason is not None:
        raise StepDamagedError(f"{step_path}: {reason}")
    parent = os.path.dirname(step_path)
    snap = os.path.join(parent, f"restore-snapshot.tmp.{os.getpid()}.pt")
    timeout_s = float(os.environ.get(_SANDBOX_TIMEOUT_ENV,
                                     _SANDBOX_TIMEOUT_DEFAULT_S))
    try:
        try:
            proc = subprocess.run(
                [sys.executable, "-m",
                 "raft_tpu_torch.training.restore_sandbox", step_path, snap],
                env=_sandbox_env(), capture_output=True, text=True,
                timeout=timeout_s or None)
        except subprocess.TimeoutExpired as exc:
            # run() has killed the sandbox
            raise StepDamagedError(
                f"restore sandbox for {step_path} hung past {timeout_s:.0f}s "
                f"({_SANDBOX_TIMEOUT_ENV}) and was killed — treating the step "
                "as unreadable") from exc
        if proc.returncode != 0:
            msg = (f"restore sandbox failed for {step_path} (exit "
                   f"{proc.returncode}): {proc.stderr.strip()[-500:]}")
            if (proc.returncode == STEP_UNREADABLE_EXIT
                    or -proc.returncode in _CRASH_SIGNALS):
                raise StepDamagedError(msg)
            raise RuntimeError(msg)
        return load_verified(snap)
    finally:
        for p in (snap, manifest_path(snap)):
            try:
                os.unlink(p)
            except OSError:
                pass


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
