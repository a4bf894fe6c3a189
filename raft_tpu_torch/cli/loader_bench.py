"""Host data-pipeline throughput, port of ``raft_tpu/cli/loader_bench.py``.

Measures the decode -> augment -> collate path of the ``PrefetchLoader``
over synthetic FlyingChairs-shaped samples written to a temporary directory
(real ``.ppm``/``.flo`` files, so the port's readers are on the measured
path) and reports image pairs per second. Compare it with the card's train
step (``--step-pairs-per-sec``, e.g. ``profile_step``'s pairs/s): the loader
has to deliver comfortably more (rule of thumb 1.5x) or it binds.

    python -m raft_tpu_torch.cli.loader_bench [--batch 8] [--samples 48] \\
        [--workers 4] [--step-pairs-per-sec 53]

Prints a summary and, last, one JSON line with the numbers. The loader runs
on the host only; no device is touched.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import tempfile
import time

import numpy as np

SYNTHETIC_HW = (384, 512)       # FlyingChairs frames


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


def main(argv=None) -> dict:
    """Run the benchmark; returns the numbers of the JSON line."""
    from raft_tpu_torch.data.loader import PrefetchLoader

    p = argparse.ArgumentParser(description="PrefetchLoader throughput")
    p.add_argument("--batch", type=int, default=6)
    p.add_argument("--samples", type=int, default=48)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--no-clamp", action="store_true",
                   help="keep more worker threads than spare cores (measures "
                        "the contended configuration)")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--step-pairs-per-sec", type=float, default=None,
                   help="the train step's pairs/s to compare against")
    p.add_argument("--wire-dtype", default="uint8",
                   choices=["uint8", "float32"],
                   help="collate wire format; uint8 is what the trainer ships")
    args = p.parse_args(argv)

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        make_synthetic_chairs(root, args.samples)
        print(f"synthesized {args.samples} pairs in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        loader = PrefetchLoader(build_dataset(root, args.samples), args.batch,
                                num_workers=args.workers,
                                clamp=not args.no_clamp,
                                wire_dtype=args.wire_dtype)
        # a warm epoch (page cache, thread start), then the timed epochs
        for _ in loader:
            pass
        pairs = 0
        t0 = time.perf_counter()
        for _ in range(args.epochs):
            for batch in loader:
                pairs += batch["image1"].shape[0]
        dt = time.perf_counter() - t0
    rate = pairs / dt
    print(f"loader: {pairs} pairs in {dt:.2f}s = {rate:.1f} pairs/s (batch "
          f"{args.batch}, {loader.num_workers} workers effective of "
          f"{args.workers} requested)", flush=True)
    out = {"metric": "loader_pairs_per_s", "pairs_per_s": rate,
           "pairs": pairs, "seconds": dt, "batch": args.batch,
           "workers": loader.num_workers, "workers_requested": args.workers,
           "wire_dtype": args.wire_dtype, "host_cores": len(
               os.sched_getaffinity(0)),
           "step_pairs_per_s": args.step_pairs_per_sec, "ratio": None,
           "binding": None}
    if args.step_pairs_per_sec:
        out["ratio"] = rate / args.step_pairs_per_sec
        out["binding"] = out["ratio"] < 1.5
        verdict = ("BINDING: the input pipeline limits the card"
                   if out["binding"] else "OK (the loader does not bind)")
        print(f"vs step {args.step_pairs_per_sec:.1f} pairs/s: "
              f"{out['ratio']:.2f}x -> {verdict}", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
