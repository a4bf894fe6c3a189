"""Training CLI, port of ``raft_tpu/cli/train.py`` (the reference's
``train.py:217-239``): the same flags, plus ``--device`` (the card unless
``cpu`` is asked for) and ``--synthetic_dir``.

    python -m raft_tpu_torch.cli.train --stage chairs --mixed_schedule \\
        --mixed_precision --synthetic 40 --num_steps 6 [--resume]

``--resume`` restores the stage's full train state (weights, AdamW moments,
schedule, step). ``--synthetic N`` writes N seeded 384x512
FlyingChairs-shaped ``.ppm``/``.flo`` pairs with the port's own writers
(into ``--synthetic_dir``, by default ``<checkpoint_dir>/synthetic_chairs_N``,
kept for a later ``--resume``) and trains on them through a chairs-stage
``FlowDataset`` and the ``PrefetchLoader``: decode, augmentation and collate
are the real pipeline.

``--supervise`` runs the training as a child process
(``training.supervisor``) and relaunches it with ``--resume`` after a
wedge (``--hang_s``'s watchdog exits 3), a signal or a crash, up to
``--max_restarts`` times; it gives up on two crashes at the same restored
step and never retries a usage error (exit 2). A fault plan in
``$RAFT_FAULT_PLAN`` or ``$RAFT_FAULT_PLAN_FILE`` (``testing.faults``) is
armed in each child::

    RAFT_FAULT_PLAN='[{"site": "trainer.step", "at": 4, "kind": "hang",
                       "attempt": 0}]' python -m raft_tpu_torch.cli.train \\
        --supervise --hang_s 60 --synthetic 8 --batch_size 8 ...

Data parallel under ``torchrun`` (``training.trainer``): each rank takes
``cuda:<LOCAL_RANK>`` and NCCL, or with ``--device cpu`` the CPU and gloo;
``--batch_size`` is the global batch, split over the ranks::

    torchrun --nproc_per_node=2 -m raft_tpu_torch.cli.train --device cpu \\
        --small --synthetic 4 --batch_size 4 --image_size 64 96 --iters 2 \\
        --num_steps 3

``--synthetic`` data is written by rank 0 and read whole by every rank,
which keeps its rows of each batch. ``--restore_ckpt`` takes the
reference's ``.pth`` or the JAX trainer's ``.msgpack``.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys

from raft_tpu_torch.cli._args import add_corr_args, corr_overrides
from raft_tpu_torch.cli.loader_bench import (build_dataset,
                                             make_synthetic_chairs)
from raft_tpu_torch.config import RAFTConfig, TrainConfig, stage_config


def build_parser() -> argparse.ArgumentParser:
    # no abbreviations: --supervise and --max_restarts are stripped from the
    # child's argv by their exact names, and an abbreviation that survived
    # the strip would start a supervisor in every child, without end
    p = argparse.ArgumentParser(description="Train RAFT on the GPU",
                                allow_abbrev=False)
    p.add_argument("--name", default="raft", help="name your experiment")
    p.add_argument("--stage", default="chairs",
                   choices=["chairs", "things", "sintel", "kitti"])
    p.add_argument("--restore_ckpt", default=None,
                   help=".pth or .msgpack weights to restore")
    p.add_argument("--resume", action="store_true",
                   help="resume the full train state from the stage dir")
    p.add_argument("--small", action="store_true")
    p.add_argument("--validation", nargs="+", default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--num_steps", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--image_size", type=int, nargs=2, default=None)
    p.add_argument("--mixed_precision", action="store_true")
    p.add_argument("--mixed_schedule", action="store_true",
                   help="use the train_mixed.sh stage presets")
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--wdecay", type=float, default=None)
    p.add_argument("--epsilon", type=float, default=1e-8)
    p.add_argument("--clip", type=float, default=1.0)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--gamma", type=float, default=None,
                   help="exponential weighting")
    p.add_argument("--add_noise", action="store_true")
    p.add_argument("--alternate_corr", action="store_true")
    p.add_argument("--fused_loss", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="sequence loss in the upsampler's subpixel domain "
                        "(basic model): identical values, no full-res "
                        "prediction stack")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--data_root", default="datasets")
    p.add_argument("--checkpoint_dir", default="checkpoints")
    p.add_argument("--log_dir", default="runs")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--val_freq", type=int, default=None,
                   help="checkpoint + validation cadence in steps")
    p.add_argument("--hang_s", type=float, default=None,
                   help="no-progress watchdog deadline in seconds (exit 3 "
                        "when the loop stops); it must cover one step (the "
                        "first with the loader's first batch), one "
                        "checkpoint save and one validation pass; the "
                        "kernels' nvcc build comes before the watch")
    p.add_argument("--on_bad_sample", choices=("raise", "skip"), default=None,
                   help="loader policy for a failing decode/augment: 'skip' "
                        "resamples with a counted warning")
    p.add_argument("--stall_s", type=float, default=None,
                   help="loader batch deadline in seconds: a hung decode "
                        "raises LoaderStallError (0 disables)")
    p.add_argument("--supervise", action="store_true",
                   help="run training as a supervised child process: "
                        "relaunch with --resume after a wedge (exit 3), a "
                        "signal or a crash; give up on two deaths at the "
                        "same restored step or after --max_restarts")
    p.add_argument("--max_restarts", type=int, default=5,
                   help="restart budget under --supervise")
    p.add_argument("--synthetic", type=int, default=None, metavar="N",
                   help="train on N generated chairs-shaped samples through "
                        "the real decode, augment and collate pipeline")
    p.add_argument("--synthetic_dir", default=None,
                   help="where --synthetic writes its samples (default "
                        "<checkpoint_dir>/synthetic_chairs_N)")
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless 'cpu' is asked for")
    add_corr_args(p)
    return p


def configs_from_args(args) -> tuple[RAFTConfig, TrainConfig]:
    model_cfg = RAFTConfig(
        small=args.small, dropout=args.dropout,
        alternate_corr=args.alternate_corr,
        mixed_precision=args.mixed_precision,
        **corr_overrides(args))
    overrides = dict(
        name=args.name, restore_ckpt=args.restore_ckpt, iters=args.iters,
        epsilon=args.epsilon, clip=args.clip, add_noise=args.add_noise,
        seed=args.seed, data_root=args.data_root,
        checkpoint_dir=args.checkpoint_dir, log_dir=args.log_dir,
        num_workers=args.num_workers)
    if args.fused_loss is not None:
        overrides["fused_loss"] = args.fused_loss
    for k in ("lr", "num_steps", "batch_size", "wdecay", "gamma",
              "val_freq", "hang_s", "on_bad_sample", "stall_s"):
        v = getattr(args, k)
        if v is not None:
            overrides[k] = v
    if args.image_size is not None:
        overrides["image_size"] = tuple(args.image_size)
    if args.validation is not None:
        overrides["validation"] = tuple(args.validation)
    train_cfg = stage_config(args.stage, mixed=args.mixed_schedule,
                             **overrides)
    return model_cfg, train_cfg


def synthetic_loader(n: int, train_cfg: TrainConfig, root=None):
    """A ``PrefetchLoader`` over ``n`` synthetic chairs samples, written once
    into ``root`` (a ``.complete`` marker makes a later run reuse them)."""
    from raft_tpu_torch.data.loader import PrefetchLoader

    if n < train_cfg.batch_size:
        raise SystemExit(
            f"--synthetic {n} < batch_size {train_cfg.batch_size}: the "
            "drop-last loader would yield no batch")
    root = root or osp.join(train_cfg.checkpoint_dir, f"synthetic_chairs_{n}")
    marker = osp.join(root, ".complete")
    if not osp.exists(marker):
        make_synthetic_chairs(root, n)
        open(marker, "w").close()
    return PrefetchLoader(build_dataset(root, n, crop=train_cfg.image_size),
                          train_cfg.batch_size,
                          num_workers=train_cfg.num_workers,
                          seed=train_cfg.seed, wire_dtype="uint8",
                          on_bad_sample=train_cfg.on_bad_sample,
                          stall_s=train_cfg.stall_s)


def main(argv=None):
    """Train one stage; returns the final ``TrainState``. Under
    ``--supervise`` it exits with the supervisor's code instead."""
    args = build_parser().parse_args(argv)
    if args.supervise:
        sys.exit(_supervise(args, argv))
    from raft_tpu_torch.evaluation.evaluate import resolve_device
    from raft_tpu_torch.testing import faults
    from raft_tpu_torch.training.trainer import train

    from raft_tpu_torch.parallel import distributed

    resolve_device(args.device)
    distributed.initialize(backend="gloo" if args.device == "cpu" else None)
    faults.arm_from_env()
    model_cfg, train_cfg = configs_from_args(args)
    loader = None
    if args.synthetic:
        # rank 0 writes the samples; the others read them once it is done
        if distributed.rank() == 0:
            loader = synthetic_loader(args.synthetic, train_cfg,
                                      args.synthetic_dir)
        distributed.barrier()
        if loader is None:
            loader = synthetic_loader(args.synthetic, train_cfg,
                                      args.synthetic_dir)
    return train(model_cfg, train_cfg, resume=args.resume, loader=loader,
                 device=args.device)


def _strip_flag(argv, flag, nargs):
    out, i = [], 0
    while i < len(argv):
        a = argv[i]
        if a == flag:
            i += 1 + nargs
            continue
        if nargs and a.startswith(flag + "="):
            i += 1
            continue
        out.append(a)
        i += 1
    return out


def _supervise(args, argv) -> int:
    """Relaunch this CLI as a supervised child with ``--resume`` forced (a
    restart must restore, not retrain) and the supervisor's own flags
    stripped; restart events go to the trainer's ``metrics.jsonl``."""
    from raft_tpu_torch.training.supervisor import Supervisor

    _, train_cfg = configs_from_args(args)
    stage_dir = os.path.join(train_cfg.checkpoint_dir, train_cfg.name,
                             train_cfg.stage)
    child = list(sys.argv[1:]) if argv is None else list(argv)
    child = _strip_flag(child, "--supervise", nargs=0)
    child = _strip_flag(child, "--max_restarts", nargs=1)
    if "--resume" not in child:
        child.append("--resume")
    sup = Supervisor([sys.executable, "-m", "raft_tpu_torch.cli.train",
                      *child],
                     max_restarts=args.max_restarts, ckpt_dir=stage_dir,
                     metrics_path=os.path.join(train_cfg.log_dir,
                                               train_cfg.name,
                                               "metrics.jsonl"))
    return sup.run()


if __name__ == "__main__":
    main()
