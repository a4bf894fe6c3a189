"""Evaluation CLI, port of ``raft_tpu/cli/evaluate.py`` (the
``evaluate.py:169-195`` analog): the same flags, plus ``--device`` (the card
by default). Weights are a reference ``.pth`` or the JAX trainer's
``.msgpack``.

    python -m raft_tpu_torch.cli.evaluate --model raft-things.pth \\
        --dataset kitti --data_root datasets [--alternate_corr] [--device cpu]
"""

from __future__ import annotations

import argparse

from raft_tpu_torch.cli._args import add_corr_args, corr_overrides
from raft_tpu_torch.config import RAFTConfig


def main(argv=None):
    p = argparse.ArgumentParser(description="Validate RAFT checkpoints")
    p.add_argument("--model", required=True,
                   help="weights: a reference .pth or a flax .msgpack")
    p.add_argument("--dataset", required=True,
                   choices=["chairs", "sintel", "kitti"])
    p.add_argument("--small", action="store_true")
    p.add_argument("--mixed_precision", action="store_true")
    p.add_argument("--alternate_corr", action="store_true")
    add_corr_args(p)
    p.add_argument("--data_root", default="datasets")
    p.add_argument("--submission", action="store_true",
                   help="write a leaderboard submission instead of validating")
    p.add_argument("--eval_batch", type=int, default=4,
                   help="pairs per forward for uniform-size datasets "
                        "(chairs/sintel); 1 = reference's per-image loop")
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless 'cpu' is asked for")
    args = p.parse_args(argv)

    from raft_tpu_torch.evaluation import evaluate as ev
    from raft_tpu_torch.tools.convert import load_weights

    cfg = RAFTConfig(small=args.small, mixed_precision=args.mixed_precision,
                     alternate_corr=args.alternate_corr,
                     **corr_overrides(args))
    ev.resolve_device(args.device)
    model = load_weights(args.model, cfg)

    if args.submission:
        if args.dataset == "sintel":
            ev.create_sintel_submission(model, cfg, warm_start=True,
                                        data_root=args.data_root,
                                        device=args.device)
        elif args.dataset == "kitti":
            ev.create_kitti_submission(model, cfg, data_root=args.data_root,
                                       device=args.device)
        else:
            p.error("submissions exist for sintel/kitti only")
        return None

    kwargs = {}
    if args.dataset in ("chairs", "sintel"):
        kwargs["batch_size"] = args.eval_batch
    results = ev.VALIDATORS[args.dataset](model, cfg, data_root=args.data_root,
                                          device=args.device, **kwargs)
    print(results)
    return results


if __name__ == "__main__":
    main()
