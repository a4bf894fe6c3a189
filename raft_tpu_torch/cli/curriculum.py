"""Curriculum driver, port of ``raft_tpu/cli/curriculum.py``: the
``train_standard.sh`` / ``train_mixed.sh`` analog, plus ``--device``.

Runs the 4-stage C -> T -> S -> K recipe (train_standard.sh:3-6), each stage
restoring the previous stage's final weights with a fresh schedule (through
``tools.convert.load_weights``, which reads the port's ``.pth`` and the
JAX trainer's ``.msgpack``); a stage whose final ``.pth`` exists and
passes its manifest is skipped.

    python -m raft_tpu_torch.cli.curriculum --stages chairs things \\
        --num_steps 1000 --data_root datasets [--mixed] [--device cpu]
"""

from __future__ import annotations

import argparse

from raft_tpu_torch.config import RAFTConfig


def main(argv=None):
    p = argparse.ArgumentParser(description="RAFT 4-stage curriculum")
    p.add_argument("--name", default="raft")
    p.add_argument("--small", action="store_true")
    p.add_argument("--mixed", action="store_true",
                   help="train_mixed.sh presets + bf16 compute")
    p.add_argument("--stages", nargs="+",
                   default=["chairs", "things", "sintel", "kitti"])
    p.add_argument("--num_steps", type=int, default=None,
                   help="override steps per stage (smoke runs)")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--data_root", default="datasets")
    p.add_argument("--checkpoint_dir", default="checkpoints")
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless 'cpu' is asked for")
    args = p.parse_args(argv)

    from raft_tpu_torch.evaluation.evaluate import resolve_device
    from raft_tpu_torch.training.trainer import train_curriculum

    resolve_device(args.device)
    model_cfg = RAFTConfig(small=args.small, mixed_precision=args.mixed)
    overrides = dict(data_root=args.data_root,
                     checkpoint_dir=args.checkpoint_dir)
    if args.num_steps is not None:
        overrides["num_steps"] = args.num_steps
    if args.batch_size is not None:
        overrides["batch_size"] = args.batch_size
    train_curriculum(args.stages, model_cfg, name=args.name,
                     mixed=args.mixed, device=args.device, **overrides)


if __name__ == "__main__":
    main()
