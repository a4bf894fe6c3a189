"""The training loop, port of ``raft_tpu/training/trainer.py``
(the reference's ``train``, train.py:136-214).

:func:`train` runs one curriculum stage on the card (or on the CPU when
asked) over an iterable of batches: the train step of
``training.train_step``, metrics summed on the device and fetched once per
``sum_freq`` window, weights-only ``<step+1>_<name>.pth`` every
``val_freq`` steps and ``<name>.pth`` at the end, in the reference's
``state_dict`` format (train.py:185-187, 211-212).

What the JAX trainer does beyond this raises ``NotImplementedError``
naming its ROADMAP item: the data pipeline behind ``loader=None`` and its
knobs ``num_workers``, ``data_root``, ``on_bad_sample``, ``stall_s`` (M13),
full-state checkpoints and ``resume=True`` (M8.1), the no-progress
watchdog ``hang_s`` (M8.2), ``profile_steps`` (M8.7) and validation (M7).
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import torch

from raft_tpu_torch.config import RAFTConfig, TrainConfig
from raft_tpu_torch.evaluation.evaluate import resolve_device
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.tools.convert import load_weights, save_pth
from raft_tpu_torch.training.logger import Logger
from raft_tpu_torch.training.train_step import (TrainState,
                                                create_train_state,
                                                make_train_step)

LOGGED = ("loss", "epe", "1px", "3px", "5px")


def _refuse_later_slices(train_cfg: TrainConfig, resume: bool, loader):
    if loader is None:
        raise NotImplementedError(
            "loader=None: the data pipeline (the datasets and their "
            "augmentation, without cv2 and PIL) is ROADMAP M13 of the port; "
            "pass an iterable of batches")
    if resume:
        raise NotImplementedError(
            "resume=True: full-state checkpoints (sha256 manifest, "
            "quarantine) are ROADMAP M8.1 of the port")
    if train_cfg.validation:
        raise NotImplementedError(
            f"validation={train_cfg.validation!r}: the validators are "
            "ROADMAP M7 of the port; pass validation=()")
    if train_cfg.profile_steps:
        raise NotImplementedError(
            "profile_steps: a trace over a step range is ROADMAP M8.7 of "
            "the port")
    if train_cfg.hang_s > 0:
        raise NotImplementedError(
            "hang_s: the no-progress watchdog is ROADMAP M8.2 of the port")
    # the data pipeline's knobs: the loader passed in does what they would
    default = TrainConfig()
    for knob in ("num_workers", "data_root", "on_bad_sample", "stall_s"):
        if getattr(train_cfg, knob) != getattr(default, knob):
            raise NotImplementedError(
                f"{knob}={getattr(train_cfg, knob)!r}: the data pipeline is "
                "ROADMAP M13 of the port; leave it at its default")


def train(model_cfg: RAFTConfig, train_cfg: TrainConfig, resume: bool = False,
          loader: Optional[Iterable] = None, device: str = "cuda"
          ) -> TrainState:
    """Run one stage for ``train_cfg.num_steps`` steps over ``loader`` (an
    iterable of batch dicts, re-iterated until the steps are done) on
    ``device``; returns the final state. Weights start from
    ``restore_ckpt`` (a reference ``.pth``) or from ``RAFT``'s init seeded
    with ``train_cfg.seed``."""
    _refuse_later_slices(train_cfg, resume, loader)
    dev = resolve_device(device)
    if train_cfg.restore_ckpt:
        model = load_weights(train_cfg.restore_ckpt, model_cfg)
    else:
        model = RAFT(model_cfg, torch.Generator().manual_seed(train_cfg.seed))
    state = create_train_state(model.to(dev), train_cfg)
    step_fn = make_train_step(model_cfg, train_cfg)
    os.makedirs(train_cfg.checkpoint_dir, exist_ok=True)
    logger = Logger(os.path.join(train_cfg.log_dir, train_cfg.name),
                    lr_fn=lambda _: state.scheduler.get_last_lr()[0])
    logger.start_at(state.step)
    sums, n = None, 0

    def flush():
        # one device-to-host fetch per window
        nonlocal sums, n
        if n:
            values = torch.stack([sums[k] for k in LOGGED]).tolist()
            logger.push_sums(dict(zip(LOGGED, values)), n)
            sums, n = None, 0

    try:
        while state.step < train_cfg.num_steps:
            start = state.step
            for batch in loader:
                metrics = step_fn(state, batch)
                sums = (metrics if sums is None
                        else {k: sums[k] + v for k, v in metrics.items()})
                n += 1
                # the reference's cadence (train.py:97-103)
                if state.step % train_cfg.sum_freq == train_cfg.sum_freq - 1:
                    flush()
                if state.step % train_cfg.val_freq == train_cfg.val_freq - 1:
                    flush()
                    save_pth(model, os.path.join(
                        train_cfg.checkpoint_dir,
                        f"{state.step + 1}_{train_cfg.name}.pth"))
                if state.step >= train_cfg.num_steps:
                    break
            if state.step == start:
                raise ValueError("the loader yielded no batch")
        flush()
        final = os.path.join(train_cfg.checkpoint_dir, f"{train_cfg.name}.pth")
        save_pth(model, final)
        print(f"saved final weights to {final}", flush=True)
    finally:
        logger.close()
    return state
