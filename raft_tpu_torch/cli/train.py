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
are the real pipeline. ``--supervise``, ``--max_restarts`` and
``--hang_s`` raise ``NotImplementedError``: the supervisor and the
watchdog are ROADMAP M8.2 of the port.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

from raft_tpu_torch.cli._args import add_corr_args, corr_overrides
from raft_tpu_torch.config import RAFTConfig, TrainConfig, stage_config

SYNTHETIC_HW = (384, 512)       # FlyingChairs frames


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train RAFT on the GPU",
                                allow_abbrev=False)
    p.add_argument("--name", default="raft", help="name your experiment")
    p.add_argument("--stage", default="chairs",
                   choices=["chairs", "things", "sintel", "kitti"])
    p.add_argument("--restore_ckpt", default=None,
                   help=".pth weights to restore")
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
                   help="no-progress watchdog (ROADMAP M8.2: raises)")
    p.add_argument("--on_bad_sample", choices=("raise", "skip"), default=None,
                   help="loader policy for a failing decode/augment: 'skip' "
                        "resamples with a counted warning")
    p.add_argument("--stall_s", type=float, default=None,
                   help="loader batch deadline in seconds: a hung decode "
                        "raises LoaderStallError (0 disables)")
    p.add_argument("--supervise", action="store_true",
                   help="supervised child process (ROADMAP M8.2: raises)")
    p.add_argument("--max_restarts", type=int, default=None,
                   help="restart budget under --supervise (ROADMAP M8.2)")
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


def make_synthetic_chairs(root: str, n: int, hw=SYNTHETIC_HW, seed: int = 0):
    """Write ``n`` FlyingChairs-shaped samples under ``root``: uint8 noise
    frames ``{i:05d}_img1.ppm``, ``_img2.ppm`` and N(0, 4²) flow
    ``{i:05d}_flow.flo``, from ``np.random.RandomState(seed)``."""
    from raft_tpu_torch.data import frame_utils
    from raft_tpu_torch.data.png import write_ppm

    rng = np.random.RandomState(seed)
    h, w = hw
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        for k in (1, 2):
            write_ppm(osp.join(root, f"{i:05d}_img{k}.ppm"),
                      rng.randint(0, 256, (h, w, 3), np.uint8))
        frame_utils.write_flow(osp.join(root, f"{i:05d}_flow.flo"),
                               rng.randn(h, w, 2).astype(np.float32) * 4)


def build_dataset(root: str, n: int, crop=(368, 496)):
    """The samples of :func:`make_synthetic_chairs` behind a ``FlowDataset``
    with the chairs stage's augmentation (datasets.py:202)."""
    from raft_tpu_torch.data.datasets import FlowDataset

    ds = FlowDataset({"crop_size": crop, "min_scale": -0.1, "max_scale": 1.0,
                      "do_flip": True})
    for i in range(n):
        ds.image_list.append([osp.join(root, f"{i:05d}_img1.ppm"),
                              osp.join(root, f"{i:05d}_img2.ppm")])
        ds.flow_list.append(osp.join(root, f"{i:05d}_flow.flo"))
    return ds


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
    """Train one stage; returns the final ``TrainState``."""
    args = build_parser().parse_args(argv)
    if args.supervise or args.max_restarts is not None:
        raise NotImplementedError(
            "--supervise/--max_restarts: the supervised restart loop is "
            "ROADMAP M8.2 of the port")
    from raft_tpu_torch.evaluation.evaluate import resolve_device
    from raft_tpu_torch.training.trainer import train

    resolve_device(args.device)
    model_cfg, train_cfg = configs_from_args(args)
    loader = None
    if args.synthetic:
        loader = synthetic_loader(args.synthetic, train_cfg,
                                  args.synthetic_dir)
    return train(model_cfg, train_cfg, resume=args.resume, loader=loader,
                 device=args.device)


if __name__ == "__main__":
    main()
