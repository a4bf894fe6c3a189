#!/usr/bin/env python3
"""K5, the on-the-fly correlation kernel, against variants of itself, on one
CUDA card.

    python3 profile_corr_alt.py

Builds ``raft_tpu_torch/csrc/corr_alt.cu`` as it stands and variants made
from it by editing the source text (each edit must find its anchor, or the
script stops), each with ``nvcc`` into ``build/profile_corr_alt/`` (all
started together), called through its ``corr_alt_launch``. Variants that
take a part out show where the time goes; variants with another box limit
(``BOX_MAX``: the largest box a tile takes to the tensor cores, the rest go
per query) show where the choice between the two branches pays; variants of
the products show what sets the error.

Inputs: ``chip_smoke.py``'s K5 operands at ``validate_kitti``'s 48x160 grid
(C=256, r=4) on both coordinate fields, with unit-variance fmaps and with
fmaps three times that; and the inputs the model really hands K5, recorded
at a few refinement steps: the basic model at random weights (seed 0) on a
synthetic KITTI pair bucketed as the validator does (what phase 10 of
``chip_smoke.py`` evaluates), and the trained small fixture on two of
``demo-frames/`` (real Sintel frames, C=128, r=3).

Per variant and input: device time by ``torch.profiler``, L2 cold; the
share of tiles on the tensor-core branch; and the error against the plain
version, as the largest absolute error, as the largest share of the
tolerance ``1e-5 + 1e-5 |plain|``, and as the largest fraction of
``sum |fmap1| |fmap2| / sqrt(C)`` over the output's taps (the scale of
fp32 rounding in a dot product). A diagnosis, not a check: the variants
that take a part out compute wrong outputs by design.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import sys

import numpy as np
import torch

from chip_smoke import (KITTI_HW, KITTI_ITERS, alt_inputs, kernel_ms,
                        kitti_bucket, kitti_eval_grid, l2_flusher,
                        synthetic_frames)

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "build", "profile_corr_alt")
def box(limit: str):
    """The edit that sets BOX_MAX to ``limit`` (the shipped value and its
    comment become a comment)."""
    return [("constexpr int BOX_MAX = ", f"constexpr int BOX_MAX = {limit}; //")]


# (name, [(anchor, replacement), ...])
VARIANTS = [
    ("as shipped", []),
    ("no copies", [(
        '  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" '
        '::"r"(d),\n               "l"(src), "r"(bytes));',
        "  (void)d;\n  (void)src;\n  (void)bytes;")]),
    ("no main loop", [("    for (int s = 0; s < total; ++s) {",
                       "    for (int s = 0; s < 0; ++s) {")]),
    ("one product", [(
        "          wgmma_tf32(part, as, core_desc(qbig + q_off), kk > 0);\n"
        "          wgmma_tf32(part, ab, core_desc(qsmall + q_off), true);\n"
        "          wgmma_tf32(part, ab, core_desc(qbig + q_off), true);\n",
        "          wgmma_tf32(part, ab, core_desc(qbig + q_off), kk > 0);\n")]),
    ("rest truncated", [(
        "  rest = tf32_round(\n"
        "      __float_as_uint(__uint_as_float(x) - __uint_as_float(big)));",
        "  rest = __float_as_uint(__uint_as_float(x) - __uint_as_float(big));")]),
    ("one accumulator", [
        ("          wgmma_tf32(part, as, core_desc(qbig + q_off), kk > 0);\n"
         "          wgmma_tf32(part, ab, core_desc(qsmall + q_off), true);\n"
         "          wgmma_tf32(part, ab, core_desc(qbig + q_off), true);\n",
         "          wgmma_tf32(acc, as, core_desc(qbig + q_off), true);\n"
         "          wgmma_tf32(acc, ab, core_desc(qsmall + q_off), true);\n"
         "          wgmma_tf32(acc, ab, core_desc(qbig + q_off), true);\n"),
        ("        for (int i = 0; i < 32; ++i) acc[i] += part[i];\n", "")]),
    ("tiled only", box("INT_MAX")),
    ("box 256", box("256")),
    ("box 384", box("384")),
    ("box 512", box("512")),
    ("box 768", box("768")),
    ("box 1024", box("1024")),
    ("box 2048", box("2048")),
    ("per-query only", box("-1")),
]


def build_all():
    """Every variant's library, the nvcc runs started together; and the
    ``ptxas`` register and spill lines of each."""
    from raft_tpu_torch.kernels import _build

    with open(os.path.join(_build.CSRC, "corr_alt.cu")) as f:
        shipped = f.read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS:
        src = shipped
        for anchor, replacement in edits:
            if anchor not in src:
                raise RuntimeError(f"{name}: anchor not found in corr_alt.cu: "
                                   f"{anchor[:60]!r}")
            src = src.replace(anchor, replacement)
        stem = os.path.join(OUT, name.replace(" ", "_"))
        with open(stem + ".cu", "w") as f:
            f.write(src)
        procs[name] = (stem, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             stem + ".so", stem + ".cu"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (stem, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"{name}: {line.strip()}")
        lib = ctypes.CDLL(stem + ".so")
        lib.corr_alt_launch.argtypes = _build.SIGNATURES["corr_alt_launch"]
        lib.corr_alt_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def recorded_inputs(config, weights, img1, img2, iters: int, steps):
    """K5's operands (fmap1, the fmap2 pyramid, coords) at the given
    refinement steps (counted from 1) of one forward of ``weights`` (a
    ``.pth`` path, or None for random weights from seed 0)."""
    import raft_tpu_torch.kernels.corr_alt as k5
    from raft_tpu_torch.evaluation.evaluate import make_forward
    from raft_tpu_torch.models.raft import RAFT
    from raft_tpu_torch.tools.convert import load_pth

    model = (RAFT(config, torch.Generator().manual_seed(0)) if weights is None
             else load_pth(weights, config))
    fwd, _ = make_forward(config, iters, device=img1.device.type)
    seen = []
    real = k5.alt_corr_lookup_cuda

    def record(fmap1, pyramid, coords, radius):
        seen.append((fmap1, list(pyramid), coords.clone()))
        return real(fmap1, pyramid, coords, radius)

    k5.alt_corr_lookup_cuda = record
    try:
        fwd(model, img1, img2)
    finally:
        k5.alt_corr_lookup_cuda = real
    if len(seen) != iters:
        raise RuntimeError(f"recorded {len(seen)} K5 calls, want {iters}")
    return {s: seen[s - 1] for s in steps}


def inputs(gen, hw=KITTI_HW):
    """name -> (fmap1, pyramid, coords, radius), on ``gen``'s device (the
    CPU rehearses with a small ``hw``, where the wrappers run the plain
    version)."""
    from raft_tpu_torch.data.png import read_png
    from raft_tpu_torch.evaluation.evaluate import _to_device_pair
    from raft_tpu_torch.models.raft import RAFTConfig

    dev = gen.device.type
    grid = kitti_eval_grid() if hw == KITTI_HW else (hw[0] // 8, hw[1] // 8)
    out = {}
    for field in ("smooth", "iid"):
        f1, pyr, coords = alt_inputs(gen, 256, 4, grid, field=field)
        out[f"{field}, randn fmaps"] = (f1, pyr, coords, 4)
        out[f"{field}, 3 x randn fmaps"] = (3 * f1, [3 * v for v in pyr],
                                           coords, 4)
    frames = synthetic_frames(10, 2, hw)
    i1, i2, _, _ = _to_device_pair(frames[0], frames[1], "kitti",
                                   kitti_bucket(), device=dev)
    cfg = RAFTConfig(alternate_corr=True, corr_impl="pallas", gru_impl="fused")
    for s, (f1, pyr, coords) in recorded_inputs(
            cfg, None, i1, i2, KITTI_ITERS, (1, 12, KITTI_ITERS)).items():
        out[f"KITTI eval, basic random weights, step {s}"] = (f1, pyr, coords,
                                                              4)
    demo = sorted(os.path.join(REPO, "demo-frames", f)
                  for f in os.listdir(os.path.join(REPO, "demo-frames"))
                  if f.endswith(".png"))
    i1, i2, _, _ = _to_device_pair(
        *(read_png(f)[:8 * (hw[0] // 8), :8 * (hw[1] // 8)].astype(np.float32)
          for f in demo[:2]), "sintel", device=dev)
    cfg = RAFTConfig(small=True, alternate_corr=True, corr_impl="pallas")
    fixture = os.path.join(REPO, "tests", "fixtures",
                           "raft-small-cputrained.pth")
    for s, (f1, pyr, coords) in recorded_inputs(cfg, fixture, i1, i2, 32,
                                                (32,)).items():
        out[f"Sintel, trained small fixture, step {s}"] = (f1, pyr, coords, 3)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_corr_alt: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch.models.corr import alt_corr_lookup

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = l2_flusher()
    counts = torch.zeros(2, dtype=torch.int64, device="cuda")
    for where, (f1, pyr, coords, r) in inputs(gen).items():
        want = alt_corr_lookup(f1, pyr, coords, r)
        scale = alt_corr_lookup(f1.abs(), [v.abs() for v in pyr], coords, r)
        B, H, W, C = f1.shape
        L = len(pyr)
        print(f"{where}: grid {H}x{W}, C={C}, r={r}, rms fmap1 "
              f"{float(f1.pow(2).mean().sqrt()):.3f}, fmap2 "
              f"{float(pyr[0].pow(2).mean().sqrt()):.3f}; largest |plain| "
              f"{float(want.abs().max()):.3f}, largest sum|a||b|/sqrt(C) "
              f"{float(scale.max()):.3f}", flush=True)
        out = torch.empty_like(want)
        for name, lib in libs.items():
            def call(lib=lib):
                code = lib.corr_alt_launch(
                    (ctypes.c_void_p * L)(*[v.data_ptr() for v in pyr]),
                    (ctypes.c_int * L)(*[v.shape[1] for v in pyr]),
                    (ctypes.c_int * L)(*[v.shape[2] for v in pyr]),
                    L, f1.data_ptr(), coords.data_ptr(), out.data_ptr(), B,
                    H, W, C, r, math.sqrt(C), counts.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"{name}: CUDA error {code}")
            counts.zero_()
            call()
            tiled, per_query = counts.tolist()
            diff = (out - want).abs()
            used = float((diff / (1e-5 + 1e-5 * want.abs())).max())
            frac = float((diff / scale.clamp(min=1e-30)).max())
            print(f"  {name}: {kernel_ms(call, 50, flush=flush):.4f} ms "
                  f"(profiler, L2 cold); {tiled / max(tiled + per_query, 1):.1%}"
                  f" of {tiled + per_query} tiles tiled; err vs plain: max "
                  f"{float(diff.max()):.3e}, {used:.3f} of the tolerance, "
                  f"{frac:.3e} of sum|a||b|/sqrt(C); {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
