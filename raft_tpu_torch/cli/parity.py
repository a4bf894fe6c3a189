"""Backend parity and timing harness, port of ``raft_tpu/cli/parity.py``
(the ``test_trt.py:52-99`` analog).

Runs the same frame pairs through (a) the plain model, the eager
``RAFT.forward`` at the exact padded shape, and (b) the serving engine
(``precompile=False``: each new shape builds its program at first use, a
captured CUDA graph on the card), reports per-pair milliseconds for both
(host clock, the card synchronised, the engine's pad, route and fetch
included) and the largest flow difference. Frames are the PNG and JPEG
files of ``--path``, read with the port's own codecs before the timed loop;
``--video`` writes the engine's flows under their first frames as an MJPG
AVI (``serving.video``). The last line of the output is one JSON object.

    python -m raft_tpu_torch.cli.parity --model raft-small.pth --small \\
        --path demo-frames [--video flow.avi] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np
import torch

from raft_tpu_torch.cli._args import add_corr_args, corr_overrides
from raft_tpu_torch.config import ITERS_EXPORT, RAFTConfig


def main(argv=None):
    """Run the comparison; returns the JSON line's numbers and the engine's
    flow for each pair."""
    from raft_tpu_torch.data.frame_utils import read_gen
    from raft_tpu_torch.evaluation.evaluate import resolve_device
    from raft_tpu_torch.ops.padding import InputPadder
    from raft_tpu_torch.serving.engine import RAFTEngine
    from raft_tpu_torch.tools.convert import load_weights

    p = argparse.ArgumentParser(description="plain model vs serving engine")
    p.add_argument("--model", required=True,
                   help="weights: a reference .pth or a flax .msgpack")
    p.add_argument("--path", required=True, help="directory of frames")
    p.add_argument("--small", action="store_true")
    p.add_argument("--iters", type=int, default=ITERS_EXPORT)
    p.add_argument("--video", default=None, help="optional output video")
    add_corr_args(p)
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless 'cpu' is asked for")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = RAFTConfig(small=args.small, **corr_overrides(args))
    model = load_weights(args.model, cfg).to(dev).eval()
    engine = RAFTEngine(model, cfg, iters=args.iters, envelope=[],
                        precompile=False, device=args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    images = sorted(glob.glob(os.path.join(args.path, "*.png"))
                    + glob.glob(os.path.join(args.path, "*.jpg")))
    if len(images) < 2:
        raise ValueError(f"{args.path}: fewer than two frames")
    # decode every frame before the timed loop (host-only work)
    decoded = [read_gen(f) for f in images]
    ms_plain, ms_engine, diffs, flows = [], [], [], []
    for name, raw1, raw2 in zip(images[:-1], decoded[:-1], decoded[1:]):
        im1 = raw1.astype(np.float32)
        im2 = raw2.astype(np.float32)
        # path A: the plain model at the exact padded shape
        t1 = torch.from_numpy(im1)[None].to(dev)
        t2 = torch.from_numpy(im2)[None].to(dev)
        padder = InputPadder(t1.shape)
        p1, p2 = padder.pad(t1, t2)
        sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            _, flow = model(p1, p2, iters=args.iters, test_mode=True)
        flow_plain = padder.unpad(flow)[0].cpu().numpy()
        ms_plain.append((time.perf_counter() - t0) * 1e3)
        # path B: the engine, its host-side pad and route included
        t0 = time.perf_counter()
        flow_eng = engine.infer_batch(im1[None], im2[None])[0]
        ms_engine.append((time.perf_counter() - t0) * 1e3)
        diffs.append(float(np.abs(flow_plain - flow_eng).max()))
        flows.append(flow_eng)
        print(f"{os.path.basename(name)}: plain {ms_plain[-1]:7.1f} ms | "
              f"engine {ms_engine[-1]:7.1f} ms | max|Δflow| {diffs[-1]:.2e}",
              flush=True)
    if args.video:
        from raft_tpu_torch.serving.video import optical_flow_visualize
        raws = [np.asarray(r, np.uint8) for r in decoded[:-1]]
        out = optical_flow_visualize(flows, args.video, images=raws)
        print(f"wrote {out}", flush=True)
    # the engine's first pair of a shape includes building its program
    steady = slice(1, None) if len(diffs) > 1 else slice(None)
    summary = {
        "pairs": len(diffs), "max_diff_px": max(diffs),
        "ms_plain": ms_plain, "ms_engine": ms_engine,
        "ms_plain_median": float(np.median(ms_plain[steady])),
        "ms_engine_median": float(np.median(ms_engine[steady])),
        "captures": engine.capture_count,
        "replayed_launches": engine.replayed_launches(),
        "iters": args.iters, "video": args.video,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")}
    print(json.dumps(summary), flush=True)
    return summary, flows


if __name__ == "__main__":
    main()
