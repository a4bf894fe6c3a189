"""Demo CLI, port of ``raft_tpu/cli/demo.py``: headless ``demo.py``.

Globs a frame directory, runs consecutive-pair flow at ``iters=20``
(demo.py:62) and writes side-by-side image/flow PNGs, with the fork's fixed
color normalization (rad=3). Same flags as the JAX demo, plus ``--device``
(the card by default). PNG and JPEG frames are read, and the PNGs written,
with the port's own codecs (``data.png``, ``data.jpeg``), since the card's
machine has no PIL; the work over numpy frames is :func:`flow_pairs`.

    python -m raft_tpu_torch.cli.demo --model raft-small.pth --small \\
        --path demo-frames --out demo_out [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import glob
import os
from typing import Callable, List, Sequence

import numpy as np
import torch

from raft_tpu_torch.cli._args import add_corr_args, corr_overrides
from raft_tpu_torch.config import ITERS_DEMO, RAFTConfig
from raft_tpu_torch.data.frame_utils import read_gen
from raft_tpu_torch.data.png import write_png
from raft_tpu_torch.ops.padding import InputPadder
from raft_tpu_torch.utils.flow_viz import flow_to_image


def flow_pairs(fwd: Callable, frames: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Flow for each consecutive pair of (H, W, 3) frames: ``fwd(image1,
    image2) -> (flow_low, flow_up)`` on padded (1, H', W', 3) inputs; returns
    one unpadded (H, W, 2) float32 numpy flow per pair."""
    flows = []
    for f1, f2 in zip(frames[:-1], frames[1:]):
        im1 = torch.from_numpy(np.asarray(f1, np.float32))[None]
        im2 = torch.from_numpy(np.asarray(f2, np.float32))[None]
        padder = InputPadder(im1.shape)
        _, flow_up = fwd(*padder.pad(im1, im2))
        flows.append(padder.unpad(flow_up)[0].cpu().numpy())
    return flows


def main(argv=None):
    from raft_tpu_torch.evaluation.evaluate import make_forward
    from raft_tpu_torch.tools.convert import load_weights

    p = argparse.ArgumentParser(description="RAFT demo on a frame directory")
    p.add_argument("--model", required=True,
                   help="weights: a reference .pth or a flax .msgpack")
    p.add_argument("--path", required=True, help="directory of frames")
    p.add_argument("--out", default="demo_out", help="output directory")
    p.add_argument("--small", action="store_true")
    p.add_argument("--mixed_precision", action="store_true")
    p.add_argument("--alternate_corr", action="store_true")
    add_corr_args(p)
    p.add_argument("--iters", type=int, default=ITERS_DEMO)
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless 'cpu' is asked for")
    args = p.parse_args(argv)

    cfg = RAFTConfig(small=args.small, mixed_precision=args.mixed_precision,
                     alternate_corr=args.alternate_corr,
                     **corr_overrides(args))
    fwd, _ = make_forward(cfg, args.iters, args.device)
    model = load_weights(args.model, cfg)

    images = sorted(glob.glob(os.path.join(args.path, "*.png"))
                    + glob.glob(os.path.join(args.path, "*.jpg")))
    os.makedirs(args.out, exist_ok=True)
    frames = [read_gen(f).astype(np.uint8) for f in images]
    flows = flow_pairs(functools.partial(fwd, model), frames)

    for imfile, frame, flow in zip(images, frames, flows):
        # side-by-side frame/flow, the viz() analog (demo.py:26-39)
        pair = np.concatenate([frame, flow_to_image(flow)], axis=0)
        name = os.path.splitext(os.path.basename(imfile))[0] + "_flow.png"
        write_png(os.path.join(args.out, name), pair)
        print(f"{imfile} -> {os.path.join(args.out, name)}", flush=True)


if __name__ == "__main__":
    main()
