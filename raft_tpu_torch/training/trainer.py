"""The training loop, port of ``raft_tpu/training/trainer.py``
(the reference's ``train``, train.py:136-214).

:func:`train` runs one curriculum stage on the card (or on the CPU when
asked): batches from the stage's ``PrefetchLoader`` (``loader=None``) or
from an iterable the caller passes, moved to the device through pinned
memory two batches ahead; the train step of ``training.train_step``;
metrics summed on the device and fetched once per ``sum_freq`` window; every
``val_freq`` steps a full-state checkpoint under
``<checkpoint_dir>/<name>/<stage>/``, the weights as ``<step+1>_<name>.pth``
(train.py:185-187) and the validators of ``train_cfg.validation``, whose
results go to the log; ``<name>.pth`` at the end (train.py:211-212).
``resume=True`` restores the newest intact full state of the stage.
``profile_steps=(a, b)`` traces steps a..b-1 with ``torch.profiler`` into
``<log_dir>/<name>``. The run's last ``metrics.jsonl`` record holds the
host's wait for the loader and each kernel's launches in the call.

:func:`train_curriculum` chains stages (train_standard.sh:3-6), skipping a
stage whose final weights exist and pass their manifest.

``hang_s > 0`` arms the no-progress watchdog (``utils.watchdog.HangWatch``),
beaten once a step and after each checkpoint and validation: a loop that
stops for ``hang_s`` exits 3 for the supervisor (``training.supervisor``,
``cli/train --supervise``) to restart with ``resume``. On the card the
kernels are built and loaded before the watch is armed, so a first build
with ``nvcc`` never counts against it. ``resume`` also moves a loader that
has ``start_at`` (the ``PrefetchLoader``) to the restored step, so the run
continues on the batches the uninterrupted run would have drawn. The fault
site ``trainer.step`` sits at the top of the loop (``testing.faults``).

Data parallel, as the JAX trainer builds its mesh on every run
(raft_tpu/training/trainer.py:106-110): :func:`train` calls
``parallel.distributed.initialize()`` (a no-op in a lone process; NCCL on
the card, gloo on the CPU), ``make_mesh()`` over every process's device
and ``mesh_model_config`` (``split_encode`` for a data axis over 1).
``batch_size`` stays the GLOBAL batch: each rank steps on its
``process_batch_slice`` rows, cut from each batch of a passed ``loader``
or decoded alone by the stage's loader (``rows=``), and the train step
sums gradients, batch-norm statistics and metrics over the ranks. Rank 0
alone writes the weights, the full states, ``metrics.jsonl`` and runs the
validation, each write followed by a barrier; ``resume`` restores the
same step on every rank; the watchdog and the supervisor are per process.
Under ``torchrun --nproc_per_node=N`` each rank takes ``cuda:<LOCAL_RANK>``
for ``device="cuda"``.

The trainer writes ``.pth`` weights (the reference's format); the JAX
trainer's ``.msgpack`` loads through ``restore_ckpt`` all the same
(``tools.convert.load_weights``).
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from raft_tpu_torch import kernels
from raft_tpu_torch.config import RAFTConfig, TrainConfig, stage_config
from raft_tpu_torch.evaluation import evaluate as ev
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.parallel import distributed
from raft_tpu_torch.parallel.mesh import make_mesh
from raft_tpu_torch.parallel.partitioner import mesh_model_config
from raft_tpu_torch.testing import faults
from raft_tpu_torch.tools.convert import (CorruptCheckpointError,
                                          load_weights, manifest_path,
                                          verify_manifest)
from raft_tpu_torch.training import checkpoint as ckpt_lib
from raft_tpu_torch.training.logger import Logger
from raft_tpu_torch.training.train_step import (TrainState,
                                                create_train_state,
                                                make_train_step)
from raft_tpu_torch.utils.ckpt_scan import (latest_step_on_disk,
                                            quarantine_path)
from raft_tpu_torch.utils.watchdog import HangWatch

LOGGED = ("loss", "epe", "1px", "3px", "5px")


def run_validation(model, model_cfg: RAFTConfig, names, data_root: str,
                   device: str = "cuda") -> Dict[str, float]:
    """The validators of ``names`` on ``device``; a dataset that is not
    staged is skipped with a message, as the JAX trainer does."""
    results: Dict[str, float] = {}
    for name in names:
        try:
            results.update(ev.VALIDATORS[name](model, model_cfg,
                                               data_root=data_root,
                                               device=device))
        except FileNotFoundError as e:
            print(f"validation '{name}' skipped: {e}", flush=True)
    return results


class DeviceBatches:
    """Each host batch of ``loader`` on ``device``, ``depth`` batches ahead
    of use: pinned host copies and ``non_blocking`` transfers, so the copy
    of batch N+1 overlaps the step on batch N (the JAX trainer's
    ``device_batches``). ``wait_s`` sums the host's seconds waiting for the
    loader."""

    def __init__(self, loader: Iterable, device: torch.device,
                 depth: int = 2):
        self.loader, self.device, self.depth = loader, device, depth
        self.wait_s = 0.0

    def _put(self, batch):
        out = {}
        for k, v in batch.items():
            t = (torch.from_numpy(np.ascontiguousarray(v))
                 if isinstance(v, np.ndarray) else v)
            if self.device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def __iter__(self):
        buf = deque()
        it = iter(self.loader)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    host = next(it)
                except StopIteration:
                    break
                self.wait_s += time.perf_counter() - t0
                buf.append(self._put(host))
                if len(buf) >= self.depth:
                    yield buf.popleft()
            while buf:
                yield buf.popleft()
        finally:
            # a loop that stops early stops the loader's workers now
            if hasattr(it, "close"):
                it.close()


class RankRows:
    """This rank's rows of each global batch of ``loader`` (a re-iterable
    of batch dicts): the trainer's cut of a passed loader under a data
    axis over 1."""

    def __init__(self, loader: Iterable, rows: slice):
        self.loader, self.rows = loader, rows

    def __iter__(self):
        for batch in self.loader:
            yield {k: v[self.rows] for k, v in batch.items()}

    def start_at(self, step: int) -> None:
        if hasattr(self.loader, "start_at"):
            self.loader.start_at(step)


class _Silent:
    """The logger of a rank other than 0: rank 0 alone writes the log."""

    def start_at(self, step: int) -> None:
        pass

    def push_sums(self, sums, n: int) -> None:
        pass

    def write_dict(self, results) -> None:
        pass

    def close(self) -> None:
        pass


def train(model_cfg: RAFTConfig, train_cfg: TrainConfig, resume: bool = False,
          loader: Optional[Iterable] = None, device: str = "cuda"
          ) -> TrainState:
    """Run one stage for ``train_cfg.num_steps`` steps on ``device``; returns
    the final state. Weights start from ``restore_ckpt`` (a reference
    ``.pth`` or a flax ``.msgpack``, a fresh schedule) or from ``RAFT``'s
    init seeded with ``train_cfg.seed``; ``resume`` then restores the
    stage's newest intact full state, schedule and step included.
    ``loader`` is an iterable of global batch dicts, re-iterated until the
    steps are done (each rank keeps its rows); None builds the stage's mix
    under ``data_root`` (``data.loader.fetch_dataloader``)."""
    dev = ev.resolve_device(str(distributed.local_device(device)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    distributed.initialize(backend="nccl" if dev.type == "cuda" else "gloo")
    mesh = make_mesh(devices=distributed.gather_devices(dev))
    model_cfg = mesh_model_config(model_cfg, mesh)
    data = mesh.shape["data"]
    if train_cfg.batch_size % data:
        raise ValueError(f"batch_size {train_cfg.batch_size} does not split "
                         f"over {data} processes")
    rows = distributed.process_batch_slice(train_cfg.batch_size)
    lead = mesh.rank == 0
    np.random.seed(train_cfg.seed)  # train.py:241-242
    torch.manual_seed(train_cfg.seed)
    stage_dir = os.path.join(train_cfg.checkpoint_dir, train_cfg.name,
                             train_cfg.stage)
    if lead:
        os.makedirs(stage_dir, exist_ok=True)
    distributed.barrier()
    if train_cfg.restore_ckpt:
        model = load_weights(train_cfg.restore_ckpt, model_cfg)
    else:
        model = RAFT(model_cfg, torch.Generator().manual_seed(train_cfg.seed))
    state = create_train_state(model.to(dev), train_cfg)
    if resume and latest_step_on_disk(stage_dir) is not None:
        ckpt_lib.restore_train_state(stage_dir, state)
        print(f"resumed from step {state.step}", flush=True)
    if loader is None:
        from raft_tpu_torch.data.loader import fetch_dataloader

        loader = fetch_dataloader(
            train_cfg.stage, train_cfg.image_size, train_cfg.batch_size,
            data_root=train_cfg.data_root, num_workers=train_cfg.num_workers,
            seed=train_cfg.seed, wire_dtype="uint8",
            on_bad_sample=train_cfg.on_bad_sample, stall_s=train_cfg.stall_s,
            rows=rows if data > 1 else None)
    elif data > 1:
        loader = RankRows(loader, rows)
    if resume and hasattr(loader, "start_at"):
        loader.start_at(state.step)
    step_fn = make_train_step(model_cfg, train_cfg, mesh)
    if dev.type == "cuda" and _uses_kernels(model_cfg):
        from raft_tpu_torch.kernels import _build

        _build.library()  # nvcc at first use: before the watch is armed
    logger = (Logger(os.path.join(train_cfg.log_dir, train_cfg.name),
                     lr_fn=lambda _: state.scheduler.get_last_lr()[0])
              if lead else _Silent())
    logger.start_at(state.step)
    prof, profiler = train_cfg.profile_steps, None
    sums, n = None, 0
    batches = DeviceBatches(loader, dev)
    first_step, t_loop, val_s = state.step, time.perf_counter(), 0.0
    launches0 = kernels.launch_counts()
    hang_watch = HangWatch(train_cfg.hang_s, label="train loop")

    def flush():
        # one device-to-host fetch per window
        nonlocal sums, n
        if n:
            values = torch.stack([sums[k] for k in LOGGED]).tolist()
            logger.push_sums(dict(zip(LOGGED, values)), n)
            sums, n = None, 0

    def stop_profiler():
        nonlocal profiler
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        profiler.stop()
        profiler = None

    hang_watch.start()
    try:
        while state.step < train_cfg.num_steps:
            start = state.step
            for batch in batches:
                # drill site: a hang here is a wedged device to the watch,
                # a crash a preemption in the middle of the run
                faults.fault_point("trainer.step")
                if (prof and profiler is None
                        and prof[0] <= state.step < prof[1]):
                    profiler = _start_profiler(
                        os.path.join(train_cfg.log_dir, train_cfg.name), dev)
                metrics = step_fn(state, batch)
                hang_watch.beat()
                if profiler is not None and state.step >= prof[1]:
                    stop_profiler()
                sums = (metrics if sums is None
                        else {k: sums[k] + v for k, v in metrics.items()})
                n += 1
                # the reference's cadence (train.py:97-103)
                if state.step % train_cfg.sum_freq == train_cfg.sum_freq - 1:
                    flush()
                if state.step % train_cfg.val_freq == train_cfg.val_freq - 1:
                    flush()  # the window's record precedes validation
                    t_val = time.perf_counter()
                    if lead:
                        ckpt_lib.save_train_state(stage_dir, state)
                        ckpt_lib.save_weights(os.path.join(
                            train_cfg.checkpoint_dir,
                            f"{state.step + 1}_{train_cfg.name}.pth"), model)
                        results = run_validation(model, model_cfg,
                                                 train_cfg.validation,
                                                 train_cfg.data_root, str(dev))
                        if results:
                            logger.write_dict(results)
                    distributed.barrier()
                    val_s += time.perf_counter() - t_val
                    hang_watch.beat()  # a long validation is no wedge
                if state.step >= train_cfg.num_steps:
                    break
            if state.step == start:
                raise ValueError("the loader yielded no batch")
        flush()
        if profiler is not None:
            stop_profiler()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        # the host's wait for batches, against the loop less its
        # checkpoints and validation
        loop_s = time.perf_counter() - t_loop
        steps = state.step - first_step
        # and each kernel's launches in this call, steps and validation
        logger.write_dict({"loader_wait_s": batches.wait_s,
                           "train_loop_s": loop_s, "validation_s": val_s,
                           "train_loop_steps": steps, **{
                               f"launches_{k}": v - launches0[k]
                               for k, v in kernels.launch_counts().items()}})
        if lead:
            print(f"loader: the host waited {batches.wait_s:.3f} s for "
                  f"batches in {loop_s - val_s:.3f} s of {steps} steps (the "
                  f"loop {loop_s:.3f} s with {val_s:.3f} s of checkpoints "
                  "and validation)", flush=True)
        final = os.path.join(train_cfg.checkpoint_dir, f"{train_cfg.name}.pth")
        hang_watch.beat()
        if lead:
            ckpt_lib.save_weights(final, model)
            print(f"saved final weights to {final}", flush=True)
        distributed.barrier()
    finally:
        # an in-process caller that catches an exception must not be
        # killed later by a watch nobody beats
        hang_watch.stop()
        if profiler is not None:
            profiler.stop()
        logger.close()
    return state


def _uses_kernels(model_cfg: RAFTConfig) -> bool:
    """Whether ``model_cfg`` runs any of the hand-written kernels: the
    lookup (K1/K3 or, with ``alternate_corr``, K5) unless ``corr_impl`` is
    the plain ``"gather"``, the GRU tails (K2/K4) with ``gru_impl="fused"``."""
    return model_cfg.corr_impl != "gather" or model_cfg.gru_impl == "fused"


def _start_profiler(trace_dir: str, dev: torch.device):
    """A ``torch.profiler`` session (the card's activity too, on the card)
    whose trace lands in ``trace_dir`` when it stops."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    p = profile(activities=acts,
                on_trace_ready=tensorboard_trace_handler(trace_dir))
    p.start()
    return p


def _final_intact(final: str) -> bool:
    """Whether a stage's final ``.pth`` may be skipped to: it must pass its
    manifest (a missing sidecar passes, as in ``verify_manifest``). A
    failing final is quarantined aside with its sidecar so the stage
    retrains and rewrites it; a read error other than a missing file
    propagates (it says nothing against the file)."""
    try:
        with open(final, "rb") as fh:
            data = fh.read()
    except FileNotFoundError:
        return False
    try:
        verify_manifest(final, data)
        return True
    except CorruptCheckpointError as exc:
        dst = quarantine_path(final)
        try:
            os.rename(final, dst)
            if os.path.exists(manifest_path(final)):
                os.rename(manifest_path(final), manifest_path(dst))
        except OSError:
            pass  # vanished mid-quarantine: retraining overwrites it
        print(f"existing final at {final} fails its integrity check "
              f"({type(exc).__name__}: {exc}) — quarantined to {dst}; "
              "retraining the stage", flush=True)
        return False


def train_curriculum(stages, model_cfg: RAFTConfig, name: str = "raft",
                     mixed: bool = False, loader_factory=None,
                     resume: bool = True, device: str = "cuda",
                     **overrides) -> None:
    """``train_standard.sh`` / ``train_mixed.sh``: chain stages, each
    restoring the previous stage's final weights with a fresh schedule
    (train_standard.sh:4-6). ``loader_factory(cfg)`` overrides each stage's
    loader. With ``resume`` (the default), a stage whose final ``.pth``
    exists and passes its manifest is skipped (its weights still chain into
    the next), a corrupt one is quarantined and the stage retrained, and
    the stage in progress resumes from its newest intact full state."""
    prev_final: Optional[str] = None
    for stage in stages:
        cfg = stage_config(stage, mixed=mixed, name=f"{name}-{stage}",
                           restore_ckpt=prev_final, **overrides)
        final = os.path.join(cfg.checkpoint_dir, f"{cfg.name}.pth")
        if resume and os.path.exists(final) and _final_intact(final):
            print(f"stage {stage}: final weights already at {final} — "
                  "skipping", flush=True)
            prev_final = final
            continue
        t0 = time.perf_counter()
        train(model_cfg, cfg, resume=resume,
              loader=loader_factory(cfg) if loader_factory else None,
              device=device)
        print(f"stage {stage} done in {time.perf_counter() - t0:.0f}s",
              flush=True)
        prev_final = final
