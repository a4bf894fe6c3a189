#!/usr/bin/env python3
"""On-card smoke run of raft_tpu_torch, the PyTorch and CUDA port.

    python3 chip_smoke.py            # every phase, on one CUDA card

Phases, each of which fails loudly (nothing is caught):

1. the device: name, count, and ``nvidia-smi``'s name and power limit;
   TF32 is turned off for cuDNN convs and matmuls, so fp32 means fp32;
2. build the kernels from ``raft_tpu_torch/csrc`` (seconds, ``-Xptxas
   -v``'s registers, shared memory and spills, each kernel's dynamic shared
   memory, and the tensor-core instructions in K5's SASS by ``cuobjdump``);
3. hold each kernel against its plain PyTorch version at the main path's
   shapes (the Sintel demo geometry padded to 440x1024: the 1/8 grid is
   55x128, N = 7040, levels 55x128, 27x64, 13x32, 6x16);
4. time each kernel, its plain version and, for the lookup, the reference's
   formulation (one ``F.grid_sample`` per level): device time from
   ``torch.profiler`` with the L2 flushed before each call (and warm, for
   the kernel), and a wrapper call's time with CUDA events (host
   included), beside its bound: the larger of its bytes at 3.35 TB/s and
   its operations at 67 TFLOP/s (the H100 SXM's HBM rate and fp32
   non-tensor-core peak); K1's in-range window rows also counted in whole
   32-byte sectors;
5. drive the main path through ``cli/demo.flow_pairs`` on 4 pairs of
   seeded synthetic 436x1024 frames at iters=20: the basic model at full
   width with seeded random weights (``corr_impl="pallas",
   gru_impl="fused"``, every launch counted) against the plain
   configuration (``corr_impl="gather", gru_impl="xla"``), held after one
   step to a bound and after 20 steps to the gap the plain path opens
   against itself on frames moved by one ulp; and the small model with
   its trained fixture, kernel lookup against plain lookup; one
   basic-model pair is profiled for the device's busy and idle time;
6. hold all six kernels (the lookup and its scatter, the gates and blend
   and their backward) against their plain versions at the training
   geometry (the chairs recipe's 368x496 crops at batch 10: the 1/8 grid
   is 46x62, B·N = 28,520 queries, levels 46x62, 23x31, 11x15, 5x7; the
   GRU's z/r halves strided views of a double-width conv output), two
   scatter calls bitwise equal, and time all six there as in phase 4,
   with the scatter's library yardstick, the backward of one
   ``F.grid_sample`` per level, and K1's sector bytes;
7. train through ``training.trainer.train`` on the chairs recipe (basic
   model at full width, batch 10, 368x496, iters 12, lr 4e-4, fp32, batch
   norms trained, ``pallas``+``fused``) for 6 steps on seeded synthetic
   batches whose ground truth is their known shift: ms per step, pairs per
   second, peak memory, launches per step of each kernel, the idle share
   of one profiled step and its top device ops; the ``.pth`` it writes
   loads back with ``strict=True``;
8. from the same weights and batch, one step's loss and gradients with the
   kernels against the plain configuration, the gradients held to the gap
   the plain path opens against itself on frames moved by one ulp: the
   basic model at iters=1, and the trained small fixture at iters=12
   (kernel lookup against plain lookup); then the basic model at iters=12
   to 10x that gap, a witness that random weights make unable to fail;
9. hold K5, the on-the-fly lookup of ``alternate_corr``, against its plain
   version at the two KITTI geometries: ``validate_kitti``'s (phase 10's
   path: a 375x1242 frame padded to 376x1248 and bucketed to 384x1280, so
   the 1/8 grid is 48x160, N = 7,680, fmap2 levels 48x160, 24x80, 12x40,
   6x20) and the unbucketed submission writer's (grid 47x156, N = 7,332);
   C=256 r=4 and C=128 r=3; on two coordinate fields (``FIELDS``: the
   smooth flow a trained model gives, with one motion boundary, and i.i.d.
   noise, the field the earlier K5 was timed on), each with a tenth of the
   queries 150 px out, which must give exact zeros; at validate_kitti's
   geometry also with fmaps three times unit variance (twice the model's); K5's branch counter read after each call (the smooth
   field must tile at least SMOOTH_TILED_MIN of its tiles); two calls
   bitwise equal; against the materialized
   path on the same fmaps (the all-pairs volume, its pooling and K1, K1
   itself against its plain version there); its gradients against plain
   autograd, and the GRU kernels (K2) at the path's (1,128,48,160); time
   K5 at the validator's geometry on both fields as in phase 4, beside its
   bound restated for tensor cores (bytes at 3.35 TB/s or the three TF32
   products of the error-compensated split at 495 TFLOP/s) with the fp32
   figure, and the materialized path's build and K1;
10. evaluate through ``cli/evaluate.main --dataset kitti --alternate_corr
   --corr_impl pallas --gru_impl fused``: the basic model at full width
   with seeded random weights saved as a ``.pth``, over a KITTI-layout
   dataset written under a temporary directory (4 seeded synthetic
   375x1242 pairs shifted by a known flow, 16-bit flow PNGs with a valid
   mask): ms per pair, peak memory, launches (24 K5 a pair, no K1), K5's
   branch shares; then
   the materialized path; the two held to each other after one step, and
   with the small trained fixture at iters=24;
11. the Sintel submission with warm start over ``demo-frames/`` in a
   ``test/{clean,final}/<scene>/`` layout, read with the port's PNG codec:
   the small fixture with K5 (its branch shares: a trained model's flow on
   real frames) against the materialized path with K1, the
   written ``.flo`` files read back and compared: cold pairs within 5e-4
   px; each warm pair run again by each path from the other's init, each
   within 5e-4 px of the other path from that init; the chained gap
   (each pair starts from the last one's flow, so the gap feeds forward)
   held to the materialized path's own response to the two inits plus
   5e-4 px;
12. memory at 1080x1920: the basic model at iters=20, alternate path
   against materialized, peak ``max_memory_allocated`` and ms per pair
   (``profile_hd_pair.py`` profiles such a pair); K1 against its plain
   version at that size (N^2 = 1.05e9 indices) and K5 against K1, both
   timed (the median of 5 profiler sessions, with their spread);
13. the demo CLI (``cli/demo.main``) over ``demo-frames/`` with the small
   fixture, its PNGs read back;
14. print the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
   the ``{"ok": true, "device": ...}`` line.

Exits non-zero, printing no result, when there is no CUDA device.
"""

from __future__ import annotations

import functools
import glob
import inspect
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12       # H100 SXM TF32 on the tensor cores, dense
SECTOR = 32                     # bytes the DRAM moves per access, at least
GRID = (55, 128)                # 1/8 grid of the 440x1024 padded Sintel frame
FRAME_HW = (436, 1024)
PAIRS = 4
ITERS = 20
LOOKUP_TOL = 1e-5               # fp32 lerp of identical window values
GRU_TOL = 1e-6                  # expf/tanhf vs PyTorch's, ~1 ulp
BASIC_STEP_TOL = 2e-3           # px, basic model, one refinement step
SMALL_TOL = 5e-4                # px, the ROADMAP's end-to-end bound
TRAIN_HW = (368, 496)           # chairs crops (train_standard.sh stage 1)
TRAIN_B = 10
TRAIN_GRID = (46, 62)
TRAIN_ITERS = 12
TRAIN_STEPS = 6
TRAIN_FLOW = (-3.0, -2.0)       # synthetic_frames' shift, frame to frame
SCATTER_TOL = 1e-5              # fp32: the same taps summed in another order
# One train step, kernels vs plain, raw gradients (no clip), cuDNN
# deterministic: the loss within 1e-5 relative (a mean of fp32 terms that
# differ by fp32 rounding); the gradients within what one ulp of input does
# to the plain path in the same run (phase 8 measures it): for each
# parameter, its gradient gap relative to its largest gradient, and the
# median of those over the parameters. The kernels change only the order
# of fp32 sums, a perturbation of the same size as one ulp of input.
STEP_LOSS_TOL = 1e-5
KITTI_HW = (375, 1242)          # KITTI-15 frames
# 1/8 grid of the 376x1248 padded frame, unbucketed (the submission
# writer's); validate_kitti's bucketed grid comes from kitti_eval_grid()
KITTI_GRID = (47, 156)
KITTI_PAIRS = 4
KITTI_ITERS = 24                # ITERS_EVAL["kitti"]
KITTI_FLOW = (-3.0, -2.0)       # synthetic_frames' shift
# K5 against its plain version: the same fp32 products summed over C in
# another order (and interpolate-then-dot against dot-then-interpolate)
ALT_ATOL = ALT_RTOL = 1e-5
ALT_MAT_TOL = 1e-4              # K5 vs the materialized path, of max |out|
# K5's coordinate fields (phase 9): "iid" is grid + 12 px i.i.d. noise per
# query (neighbouring windows unrelated: the worst case for a tiled kernel);
# "smooth" is grid + KITTI_FLOW + a low-frequency flow of up to +-8 px (a
# wavelength of the grid width) + one vertical motion boundary where the
# flow jumps by SMOOTH_JUMP px; both with a tenth of the queries 150 px out
FIELDS = ("smooth", "iid")
SMOOTH_AMP = 8.0
SMOOTH_JUMP = 20.0
SMOOTH_TILED_MIN = 0.9          # share of K5 tiles the smooth field must tile
HD_HW = (1080, 1920)            # the memory regime alternate_corr is for
HD_ITERS = 20


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's log, ending in the seconds since the start."""
    print(f"{msg} (+{time.perf_counter() - _T0:.1f} s)", flush=True)


def cuda_ms(fn, reps: int = 100, warmup: int = 10) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` back-to-back calls,
    by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_events(prof):
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_busy_ms(prof) -> float:
    """Milliseconds in which at least one kernel or copy ran on the card:
    the union of the device events' intervals (a sum of their times counts
    twice what overlaps, as cuDNN's kernels on its own streams do)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    if not busy > 0:
        raise RuntimeError("torch.profiler recorded no device intervals")
    return busy / 1e3


def kernel_ms(fn, reps: int = 50, flush=None):
    """Device milliseconds per call of ``fn``: the device time of everything
    it ran on the card, from ``torch.profiler``, over ``reps`` calls after a
    warm-up, divided by the calls the profiler recorded. With ``flush`` (a
    device-to-device copy larger than the 50 MB L2), each call finds the L2
    cold; the copies' own time is left out.

    A session can lose device events: two or three of a session of any
    length (a one-call session of K5 recorded none, one of the materialized
    build 2 of its 5 kernels, ten of it 48 of 50), once all of them, once
    all but one of 20 calls. So each session starts and ends on eight small
    device-to-device copies, left out like the flushes, and the calls
    recorded are counted by the costliest kernel: its events over how many
    one call runs (its events per call, rounded). A session that recorded
    fewer than three quarters of its calls, or more than 5% over the calls
    it made, is taken again, up to four times; raises if none was whole
    enough."""
    from torch.profiler import ProfilerActivity, profile

    pad_src = torch.empty(2 ** 20, device="cuda")
    pad_dst = torch.empty_like(pad_src)

    def pad():
        for _ in range(8):
            pad_dst.copy_(pad_src)
        torch.cuda.synchronize()

    fn()  # warm-up: one-time set-up launches stay out of the count below
    torch.cuda.synchronize()
    for attempt in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad()
            for _ in range(reps):
                if flush is not None:
                    flush()
                fn()
            pad()
        evs = {e.key: (e.self_device_time_total, e.count)
               for e in device_events(prof)
               if not e.key.startswith("Memcpy DtoD")}
        us = sum(t for t, _ in evs.values())
        key, (_, n) = max(evs.items(), key=lambda kv: kv[1][0],
                          default=(None, (0.0, 0)))
        per_call = round(n / reps)
        calls = n / per_call if per_call else 0.0
        if us > 0 and 0.75 * reps <= calls <= 1.05 * reps:
            return us / calls / 1e3
        log(f"    torch.profiler recorded {calls:.2f} of {reps} calls "
            f"({sum(c for _, c in evs.values())} events, {n} of {key!r}; "
            f"session {attempt + 1} of 4)")
    raise RuntimeError("torch.profiler recorded too few or too many calls")


def median_kernel_ms(fn, reps: int, sessions: int, flush=None):
    """(median, least, most) of ``sessions`` ``kernel_ms`` readings, for a
    call whose time spreads from one session to the next."""
    ms = sorted(kernel_ms(fn, reps, flush=flush) for _ in range(sessions))
    return float(np.median(ms)), ms[0], ms[-1]


def bound_ms(nbytes: float, ops: float, flops_per_s: float = FP32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def bf16_ulp_ok(got, want) -> bool:
    """Within one bf16 ulp: |diff| <= 2^-7 * max(|plain|, 1) (one bf16
    rounding of the same fp32 value may land one ulp apart)."""
    return bool(((got.float() - want.float()).abs()
                 <= 2 ** -7 * want.float().abs().clamp(min=1)).all())


def hold_gru(tag: str, pairs, dtype, shape: str, err, err_bf16) -> None:
    """Phases 3 and 6: each ``name: (kernel outputs, plain outputs)``
    within GRU_TOL in fp32 and one bf16 ulp in bf16; the largest error
    over both phases goes into ``err`` or ``err_bf16``."""
    for name, (got, want) in pairs.items():
        e = max(max_err(a, w) for a, w in zip(got, want))
        if dtype == torch.float32:
            ok, bound = e <= GRU_TOL, f"tol {GRU_TOL:g}"
            err[name] = max(err.get(name, 0.0), e)
        else:
            ok = all(bf16_ulp_ok(a, w) for a, w in zip(got, want))
            bound = "bound one bf16 ulp: 2^-7*max(|plain|,1)"
            err_bf16[name] = max(err_bf16.get(name, 0.0), e)
        log(f"[{tag}] {name} {str(dtype)[6:]} {shape}: max abs err {e:.3e} "
            f"({bound})")
        if not ok:
            raise RuntimeError(f"{name} disagrees with its plain version")


def l2_flusher():
    """A 128 MB device-to-device copy, more than the 50 MB L2: run before a
    call, it leaves the L2 cold (``kernel_ms`` leaves its time out)."""
    src = torch.empty(32 * 2 ** 20, device="cuda")
    dst = torch.empty_like(src)
    return lambda: dst.copy_(src)


def time_kernels(tag: str, work, smi: str, reps: int, plain_reps: int,
                 where: str = ""):
    """Phases 4 and 6: for each ``name: (kernel, plain, library or None,
    bytes, operations)``, device times L2 cold (a 128 MB copy, more than
    the 50 MB L2, before each call; the copies' own time left out) and,
    for the kernel, L2 warm, beside the bound; logged with the card."""
    flush = l2_flusher()
    times = {}
    for name, (kern, plain, library, nb, ops) in work.items():
        t = times[name] = dict(
            ms=kernel_ms(kern, reps, flush=flush),
            ms_l2_warm=kernel_ms(kern, reps),
            plain_ms=kernel_ms(plain, plain_reps, flush=flush),
            library_ms=(None if library is None
                        else kernel_ms(library, plain_reps, flush=flush)),
            bound=bound_ms(nb, ops), mbytes=nb / 1e6)
        lib = ("" if t["library_ms"] is None
               else f", library {t['library_ms']:.4f} ms")
        log(f"[{tag}] {name}{where}: kernel {t['ms']:.4f} ms (profiler, L2 "
            f"cold; {t['ms_l2_warm']:.4f} ms L2 warm), plain {t['plain_ms']:.4f} "
            f"ms{lib}, bound {t['bound'][0]:.4f} ms by {t['bound'][1]} "
            f"({nb / 1e6:.2f} MB); {smi}")
    return times


# ---------------------------------------------------------------------------
# phase 3-4 inputs and yardsticks
# ---------------------------------------------------------------------------

def lookup_inputs(gen: torch.Generator, dtype: torch.dtype, B: int = 1,
                  grid=GRID):
    """A pyramid (B, N, Hl, Wl) and coords (B, H, W, 2) at a path's
    geometry (by default the inference path's, N = 7040 on a 55x128 grid):
    grid + random flow, with a tenth of the queries far outside the image."""
    H, W = grid
    N = H * W
    vol = torch.randn((B, N, H, W), generator=gen, device="cuda")
    pyramid = [vol]
    for _ in range(3):
        pyramid.append(F.avg_pool2d(pyramid[-1], 2, stride=2))
    pyramid = [v.to(dtype).contiguous() for v in pyramid]
    ys, xs = torch.meshgrid(torch.arange(H, device="cuda", dtype=torch.float32),
                            torch.arange(W, device="cuda", dtype=torch.float32),
                            indexing="ij")
    coords = torch.stack([xs, ys], -1)[None].expand(B, H, W, 2)
    coords = coords + 12.0 * torch.randn(coords.shape, generator=gen,
                                         device="cuda")
    far = torch.rand((B, H, W, 1), generator=gen, device="cuda") < 0.1
    coords = torch.where(far, coords + 150.0 * torch.sign(
        torch.randn(coords.shape, generator=gen, device="cuda")), coords)
    return pyramid, coords.contiguous()


def lookup_grid_sample(pyramid, coords, radius: int) -> torch.Tensor:
    """The reference's lookup (core/corr.py:29-50): one bilinear
    ``F.grid_sample`` per level, zeros padding, align_corners=True. A
    yardstick only; the port never calls it."""
    B, H, W, _ = coords.shape
    K = 2 * radius + 1
    d = torch.arange(-radius, radius + 1, device=coords.device,
                     dtype=torch.float32)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), -1)  # (dx, dy)
    out = []
    for i, vol in enumerate(pyramid):
        Hl, Wl = vol.shape[-2:]
        pts = coords.reshape(B * H * W, 1, 1, 2) / 2 ** i + delta[None]
        grid = torch.stack([2 * pts[..., 0] / (Wl - 1) - 1,
                            2 * pts[..., 1] / (Hl - 1) - 1], -1)
        img = vol.reshape(B * H * W, 1, Hl, Wl).float()
        s = F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=True)
        out.append(s.reshape(B, H, W, K * K))
    return torch.cat(out, -1)


def in_range_taps(coords, level: int, Hl: int, Wl: int, radius: int):
    """Per query, how many taps of its (2r+2)² window at ``level`` lie
    inside the Hl x Wl level (coords clamped as the kernels clamp them)."""
    K = 2 * radius + 1

    def span(c, size):
        c = (c / 2 ** level).clamp(-(radius + 2.0), size + radius + 1.0)
        lo = torch.floor(c) - radius
        return ((lo + K).clamp(max=size - 1) - lo.clamp(min=0) + 1).clamp(min=0)

    return span(coords[..., 0], Wl) * span(coords[..., 1], Hl)


def lookup_bytes(pyramid, coords, radius: int) -> float:
    """Bytes this run's lookup must move: the in-range part of every
    (2r+2)² window read once, coords read once, the output written once."""
    K = 2 * radius + 1
    total = coords.numel() * 4 + coords[..., 0].numel() * len(pyramid) * K * K * 4
    for i, vol in enumerate(pyramid):
        Hl, Wl = vol.shape[-2:]
        taps = in_range_taps(coords, i, Hl, Wl, radius)
        total += float(taps.sum()) * vol.element_size()
    return total


def lookup_sector_bytes(pyramid, coords, radius: int) -> float:
    """``lookup_bytes`` with each in-range window row counted in the whole
    32-byte sectors it touches (the unit the DRAM moves; the levels are
    allocated sector-aligned): the bytes a design that reads each window
    row once still moves."""
    B, H, W, _ = coords.shape
    K = 2 * radius + 1
    P = K + 1
    n = B * H * W
    total = coords.numel() * 4 + n * len(pyramid) * K * K * 4
    q = torch.arange(n, device=coords.device, dtype=torch.float64)
    for i, vol in enumerate(pyramid):
        Hl, Wl = vol.shape[-2:]
        es = vol.element_size()

        def origin(c, size):
            c = (c.reshape(-1) / 2 ** i).clamp(-(radius + 2.0), size + radius + 1.0)
            return torch.floor(c).double() - radius

        x0, y0 = origin(coords[..., 0], Wl), origin(coords[..., 1], Hl)
        lo, hi = x0.clamp(min=0), (x0 + P - 1).clamp(max=Wl - 1)
        for dy in range(P):
            iy = y0 + dy
            ok = (iy >= 0) & (iy < Hl) & (lo <= hi)
            start = ((q * Hl + iy) * Wl + lo) * es
            end = ((q * Hl + iy) * Wl + hi) * es + es - 1
            sectors = torch.floor(end / SECTOR) - torch.floor(start / SECTOR) + 1
            total += float(torch.where(ok, sectors, 0).sum()) * SECTOR
    return total


def note_sectors(tag: str, t: dict, pyramid, coords, smi: str) -> None:
    """Phases 4 and 6: K1's bytes counted in whole 32-byte sectors beside
    its bound, and the shares of each that its time reaches."""
    sb = lookup_sector_bytes(pyramid, coords, 4)
    t["sector_mbytes"] = sb / 1e6
    t["sector_ms"] = sb / HBM_BYTES_PER_S * 1e3
    log(f"[{tag}] corr_lookup: in-range window rows in whole 32-byte sectors "
        f"{sb / 1e6:.2f} MB ({sb / (t['mbytes'] * 1e6):.2f}x the bound's "
        f"{t['mbytes']:.2f} MB), {t['sector_ms']:.4f} ms at 3.35 TB/s; kernel "
        f"at {t['bound'][0] / t['ms']:.1%} of its bound, "
        f"{t['sector_ms'] / t['ms']:.1%} of the sector time; {smi}")


# ---------------------------------------------------------------------------
# phase 5 inputs
# ---------------------------------------------------------------------------

def synthetic_frames(seed: int, n: int, hw=FRAME_HW):
    """``n`` frames of a smooth random texture, each shifted by (2, 3) px
    from the last (a flow of (-3, -2) in (x, y)), as (H, W, 3) float32 in
    [0, 255]."""
    H, W = hw
    m = 4 * n
    rng = np.random.RandomState(seed)
    noise = rng.randn(H + m, W + m, 3)
    f = np.fft.fft2(noise, axes=(0, 1))
    ky = np.fft.fftfreq(H + m)[:, None, None]
    kx = np.fft.fftfreq(W + m)[None, :, None]
    f *= np.exp(-(kx ** 2 + ky ** 2) / (2 * 0.03 ** 2))
    t = np.real(np.fft.ifft2(f, axes=(0, 1)))
    t = ((t - t.min()) / (t.max() - t.min()) * 255).astype(np.float32)
    return [t[2 * k:2 * k + H, 3 * k:3 * k + W] for k in range(n)]


def run_pairs(model, config, frames, iters: int):
    """One timed ``flow_pairs`` run: (flows, ms per pair, peak MB)."""
    from raft_tpu_torch.cli.demo import flow_pairs
    from raft_tpu_torch.evaluation.evaluate import make_forward

    fwd, _ = make_forward(config, iters, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    flows = flow_pairs(functools.partial(fwd, model), frames)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (len(frames) - 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    for f in flows:
        if not np.isfinite(f).all() or f.shape != frames[0].shape[:2] + (2,):
            raise RuntimeError(f"bad flow: shape {f.shape}, finite "
                               f"{np.isfinite(f).all()}")
    return flows, ms, peak


def flow_diff(a, b) -> float:
    return float(max(np.abs(x - y).max() for x, y in zip(a, b)))


# ---------------------------------------------------------------------------
# phases 6-8: the training path
# ---------------------------------------------------------------------------

def scatter_bytes(pyramid, coords, radius: int) -> float:
    """Bytes the lookup's backward must move: the cotangent and coords
    read once, the whole gradient volume written once (zero outside the
    windows)."""
    K = 2 * radius + 1
    n = coords[..., 0].numel()
    return (n * len(pyramid) * K * K * 4 + coords.numel() * 4
            + sum(v.numel() * v.element_size() for v in pyramid))


def gru_bwd_inputs(gen: torch.Generator, dtype: torch.dtype, B: int = TRAIN_B,
                   grid=TRAIN_GRID):
    """A path's GRU operands, forward and backward, by default the training
    path's (10, 128, 46, 62): zl and rl as the strided channel halves of a
    double-width conv output, as the update block hands them."""
    shape = (B, 128) + tuple(grid)

    def rand(*s):
        return (3 * torch.randn(s, generator=gen, device=gen.device)).to(dtype)

    zr = rand(B, 256, *grid)
    h, ql, dz, drh, g = (rand(*shape) / 3 for _ in range(5))
    z = torch.sigmoid(rand(*shape).float()).to(dtype)
    return zr[:, :128], zr[:, 128:], h, ql, dz, drh, g, z


def train_batch(seed: int):
    """A chairs-geometry batch on the loader's uint8 wire: TRAIN_B pairs of
    consecutive synthetic frames, ground truth their known shift, every
    pixel valid."""
    H, W = TRAIN_HW
    frames = synthetic_frames(seed, TRAIN_B + 1, TRAIN_HW)
    frames = [np.round(f).astype(np.uint8) for f in frames]
    return {"image1": np.stack(frames[:-1]), "image2": np.stack(frames[1:]),
            "flow": np.broadcast_to(np.float32(TRAIN_FLOW),
                                    (TRAIN_B, H, W, 2)).copy(),
            "valid": np.ones((TRAIN_B, H, W), np.uint8)}


class TimedLoader:
    """The batches, with the host clock read (device synchronised) each time
    the trainer asks for the next one: mark k+1 - mark k is step k."""

    def __init__(self, batches):
        self.batches = batches
        self.marks = []

    def __iter__(self):
        for b in self.batches:
            torch.cuda.synchronize()
            self.marks.append(time.perf_counter())
            yield b


def train_config(**kw):
    from raft_tpu_torch.config import stage_config

    base = dict(batch_size=TRAIN_B, image_size=TRAIN_HW, iters=TRAIN_ITERS,
                validation=())
    base.update(kw)
    return stage_config("chairs", **base)


def step_grads(config, weights, batch, iters: int):
    """One train step from ``weights`` on ``batch``: (loss, raw gradient of
    every parameter). The clip is set out of reach so the gradients are the
    backward's own."""
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.training.train_step import (create_train_state,
                                                    make_train_step)

    model = RAFT(config)
    model.load_state_dict(weights)
    tc = train_config(iters=iters, clip=float("inf"))
    state = create_train_state(model.cuda(), tc)
    metrics = make_train_step(config, tc)(state, batch)
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    return float(metrics["loss"]), grads


def step_gap(a, b):
    """Between two ``step_grads`` results: (relative loss gap; the largest
    and the median over parameters of max|grad gap| / max|grad|; each
    parameter's (max|grad gap|, max|grad|); the model's largest gradient).
    Parameters whose gradient is under 1e-4 of the model's largest (biases
    in front of a norm, zero in exact arithmetic) are left out of the
    largest and the median; the per-parameter bound covers them."""
    (la, ga), (lb, gb) = a, b
    gmax = max(float(g.abs().max()) for g in gb.values())
    rel, worst = [], {}
    for k in gb:
        scale = float(gb[k].abs().max())
        err = float((ga[k] - gb[k]).abs().max())
        worst[k] = (err, scale)
        if scale > 1e-4 * gmax:
            rel.append(err / scale)
    return abs(la - lb) / abs(lb), max(rel), float(np.median(rel)), worst, gmax


def check_step(name, plain, kernels, ulp):
    """Phase 8: one step's kernels-vs-plain gap against STEP_LOSS_TOL for
    the loss and, for the gradients, the gap that the plain path opens
    against itself on inputs moved by one ulp (``ulp``): each parameter's
    within the largest relative one-ulp gap of the model (plus 1e-6 of its
    largest gradient), and the median within the one-ulp median."""
    dl, worst_rel, median, worst, gmax = step_gap(kernels, plain)
    _, grad_tol, median_tol, _, _ = step_gap(ulp, plain)
    bad = [(k, e, s) for k, (e, s) in worst.items()
           if not e <= grad_tol * s + 1e-6 * gmax]
    log(f"[8] {name}: loss gap {dl:.3e} (tol {STEP_LOSS_TOL:g}), gradient "
        f"gap largest {worst_rel:.3e} of a parameter's largest (bound: one "
        f"ulp of input, {grad_tol:.3e}, + 1e-6 of the model's), median "
        f"{median:.3e} (bound: one ulp of input, {median_tol:.3e})")
    if not (dl <= STEP_LOSS_TOL and not bad and median <= median_tol):
        raise RuntimeError(f"{name}: kernels disagree with plain: {bad[:5]}")


# ---------------------------------------------------------------------------
# phases 9-13: the alternate path (K5) and evaluation
# ---------------------------------------------------------------------------

def smooth_flow(grid, device, amp: float = SMOOTH_AMP,
                jump: float = SMOOTH_JUMP):
    """(1, H, W, 2) flow like a trained model's: KITTI_FLOW, plus a
    low-frequency field of up to +-``amp`` px whose wavelength is the grid
    width, plus ``jump`` px in x right of a vertical motion boundary that
    cuts a column of 8x8 tiles (at W/2 + 3)."""
    H, W = grid
    ys, xs = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(W, device=device, dtype=torch.float32),
                            indexing="ij")
    u = KITTI_FLOW[0] + amp * torch.sin(2 * np.pi * (xs + ys) / W)
    v = KITTI_FLOW[1] + amp * torch.cos(2 * np.pi * (xs - ys) / W)
    u = u + jump * (xs >= W // 2 + 3)
    return torch.stack([u, v], -1)[None]


def alt_inputs(gen: torch.Generator, C: int, radius: int, grid,
               levels: int = 4, field: str = "iid", scale: float = 1.0):
    """K5's operands at a path's 1/8 grid, on ``gen``'s device: fmap1 (1,
    H, W, C) and the NHWC fmap2 pyramid pooled from a random fmap2, both
    ``scale`` times unit variance, and coords
    = grid + a flow (``field``: "iid", 12 px of i.i.d. noise per query, or
    "smooth", ``smooth_flow``) with a tenth of the queries 150 px out and
    the first query's window straddling the top-left corner."""
    from raft_tpu_torch.models.corr import AlternateCorrBlock

    H, W = grid
    dev = gen.device
    f1, f2 = (scale * torch.randn((1, H, W, C), generator=gen, device=dev)
              for _ in range(2))
    block = AlternateCorrBlock(f1, f2, levels, radius)
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32),
                            indexing="ij")
    coords = torch.stack([xs, ys], -1)[None]
    if field == "iid":
        coords = coords + 12.0 * torch.randn(coords.shape, generator=gen,
                                             device=dev)
    elif field == "smooth":
        coords = coords + smooth_flow(grid, dev)
    else:
        raise ValueError(f"field {field!r}: one of {FIELDS}")
    far = torch.rand((1, H, W, 1), generator=gen, device=dev) < 0.1
    coords = torch.where(far, coords + 150.0 * torch.sign(
        torch.randn(coords.shape, generator=gen, device=dev)), coords)
    coords[0, 0, 0] = torch.tensor([-0.5, -1.5])
    return block.fmap1, block.fmap2_pyramid, coords.contiguous()


def kitti_bucket():
    """``validate_kitti``'s default ``shape_bucket``."""
    from raft_tpu_torch.evaluation.evaluate import validate_kitti

    return inspect.signature(validate_kitti).parameters["shape_bucket"].default


def kitti_eval_grid():
    """The 1/8 grid that ``validate_kitti`` hands the model for a KITTI
    frame: padded to a multiple of 8, then edge-filled to its default
    ``shape_bucket`` (375x1242 -> 384x1280, grid 48x160)."""
    from raft_tpu_torch.evaluation.evaluate import _to_device_pair

    frame = np.zeros(KITTI_HW + (3,), np.float32)
    i1, _, _, _ = _to_device_pair(frame, frame, "kitti", kitti_bucket(),
                                  device="cpu")
    return i1.shape[1] // 8, i1.shape[2] // 8


def k5_branches(fn, device):
    """``fn()`` with K5's branch counters on ``device`` set to 0 just
    before: (its result, (tiles on the tiled branch, tiles on the per-query
    branch)). On the CPU, where the wrappers run the plain version, (0, 0)."""
    from raft_tpu_torch.kernels.corr_alt import branch_counts

    if torch.device(device).type != "cuda":
        return fn(), (0, 0)
    counts = branch_counts(device)
    counts.zero_()
    out = fn()
    tiled, per_query = counts.tolist()
    return out, (tiled, per_query)


def branch_note(branches) -> str:
    tiled, per_query = branches
    n = tiled + per_query
    if not n:
        return "no corr_alt tiles"
    return (f"{tiled} tiles tiled, {per_query} per-query ({tiled / n:.1%} "
            "tiled)")


def check_alt(gen: torch.Generator, grid, C: int, radius: int, where: str,
              field: str = "iid", scale: float = 1.0):
    """Phase 9 at one geometry, coordinate field and fmap magnitude
    (``scale`` times unit variance): K5 against its plain version (ALT_ATOL
    + ALT_RTOL, exact zeros for the far-out queries, two calls bitwise
    equal; the error also logged as a fraction of sum |fmap1| |fmap2| /
    sqrt(C), the scale of fp32 rounding in the dots), and against the
    materialized path on the same fmaps, whose K1 is held against its plain
    version too. Returns (K5's error, K1's, K5's (tiled, per-query)
    tiles)."""
    from raft_tpu_torch.kernels.corr_alt import alt_corr_lookup_cuda
    from raft_tpu_torch.kernels.corr_lookup import corr_lookup_cuda
    from raft_tpu_torch.models.corr import (alt_corr_lookup,
                                            build_corr_pyramid,
                                            corr_lookup_gather)

    f1, pyr, coords = alt_inputs(gen, C, radius, grid, field=field,
                                 scale=scale)
    got, branches = k5_branches(
        lambda: alt_corr_lookup_cuda(f1, pyr, coords, radius), coords.device)
    again = alt_corr_lookup_cuda(f1, pyr, coords, radius)
    want = alt_corr_lookup(f1, pyr, coords, radius)
    diff = (got - want).abs()
    e = float(diff.max())
    within = bool((diff <= ALT_ATOL + ALT_RTOL * want.abs()).all())
    used = float((diff / (ALT_ATOL + ALT_RTOL * want.abs())).max())
    mag = alt_corr_lookup(f1.abs(), [v.abs() for v in pyr], coords, radius)
    frac = float((diff / mag.clamp(min=1e-30)).max())
    far = far_queries(coords, radius)
    zeros = bool(far.any()) and not bool(got[far].any())
    bitwise = torch.equal(got, again)
    shape = (f"C={C} r={radius}, grid {grid[0]}x{grid[1]} ({where}), {field} "
             f"field, fmaps {scale:g} x randn")
    log(f"[9] corr_alt {shape}: max abs err {e:.3e} vs the plain version "
        f"(tol {ALT_ATOL:g} + {ALT_RTOL:g} relative: {used:.3f} of it used; "
        f"{frac:.3e} of sum|fmap1||fmap2|/sqrt(C)); {int(far.sum())} "
        f"far-out queries exact zeros: {zeros}; two calls bitwise equal: "
        f"{bitwise}; {branch_note(branches)}")
    if not (within and zeros and bitwise):
        raise RuntimeError("corr_alt disagrees with its plain version")
    mat_pyr = build_corr_pyramid(f1, pyr[0])
    mat = corr_lookup_cuda(mat_pyr, coords, radius)
    e_k1 = max_err(mat, corr_lookup_gather(mat_pyr, coords, radius))
    e_mat, scale = max_err(got, mat), float(mat.abs().max())
    log(f"[9] corr_alt {shape} vs the materialized path (volume + pooling "
        f"+ corr_lookup): max abs err {e_mat:.3e}, {e_mat / scale:.3e} of "
        f"the largest output {scale:.3f} (tol {ALT_MAT_TOL:g}); that "
        f"corr_lookup vs its plain version {e_k1:.3e} (tol {LOOKUP_TOL:g})")
    if not e_mat <= ALT_MAT_TOL * scale:
        raise RuntimeError("corr_alt disagrees with the materialized path")
    if not e_k1 <= LOOKUP_TOL:
        raise RuntimeError("corr_lookup disagrees with its plain version")
    return e, e_k1, branches


def sass_mma_counts(lib_path: str) -> dict:
    """Per kernel of the built library whose name holds "corr": how many
    tensor-core matrix multiply instructions (HMMA, and HGMMA for wgmma) its
    SASS has, read with the toolkit's ``cuobjdump -sass``."""
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if "corr" in name:
                counts[name] = 0
        elif name in counts and ("HMMA" in line or "HGMMA" in line):
            counts[name] += 1
    return counts


def alt_bound(nbytes: float, ops: float):
    """K5's bound, restated for tensor cores: the larger of its bytes at
    3.35 TB/s and its operations done as three TF32 products each (the
    error-compensated split) at 495 TFLOP/s; and the fp32 figure, the
    operations at 67 TFLOP/s on the CUDA cores, which a tensor-core kernel
    can beat."""
    return (bound_ms(nbytes, 3 * ops, TF32_FLOPS_PER_S),
            bound_ms(nbytes, ops, FP32_FLOPS_PER_S))


def alt_cost(fmap1, pyramid, coords, radius: int):
    """(bytes, operations) this run's K5 call needs: fmap1, the pyramid and
    coords read once and the output written once; 2·C operations for each
    in-range tap of each (2r+2)² window (out-of-range taps are not dotted)
    and 10 for each output's lerp and scale."""
    C = fmap1.shape[-1]
    K = 2 * radius + 1
    n = coords[..., 0].numel()
    taps = sum(float(in_range_taps(coords, i, v.shape[1], v.shape[2],
                                   radius).sum())
               for i, v in enumerate(pyramid))
    nbytes = 4 * (fmap1.numel() + sum(v.numel() for v in pyramid)
                  + coords.numel() + n * len(pyramid) * K * K)
    return nbytes, taps * 2 * C + n * len(pyramid) * K * K * 10


def far_queries(coords, radius: int, levels: int = 4):
    """Queries whose windows miss every level: more than (r+1)·2^(L-1) px
    outside the level-0 grid."""
    _, H, W, _ = coords.shape
    m = (radius + 1) * 2 ** (levels - 1) + 1
    x, y = coords[..., 0], coords[..., 1]
    return (x < -m) | (x > W - 1 + m) | (y < -m) | (y > H - 1 + m)


def write_kitti(root: str, n: int = KITTI_PAIRS):
    """A KITTI-15 training split in its on-disk layout: ``n`` pairs of
    seeded synthetic 375x1242 frames (``image_2/*_10.png``, ``*_11.png``),
    the second shifted by KITTI_FLOW, and 16-bit flow PNGs
    (``flow_occ/*_10.png``: (u, v, valid) with a third of the pixels
    invalid, as KITTI's sparse ground truth)."""
    from raft_tpu_torch.data.png import write_png

    for d in ("image_2", "flow_occ"):
        os.makedirs(os.path.join(root, "training", d), exist_ok=True)
    rng = np.random.RandomState(7)
    H, W = KITTI_HW
    for i in range(n):
        f1, f2 = (np.round(f).astype(np.uint8)
                  for f in synthetic_frames(10 + i, 2, KITTI_HW))
        write_png(os.path.join(root, "training", "image_2", f"{i:06d}_10.png"), f1)
        write_png(os.path.join(root, "training", "image_2", f"{i:06d}_11.png"), f2)
        uv = np.broadcast_to(np.float32(KITTI_FLOW), (H, W, 2))
        valid = (rng.rand(H, W, 1) > 1 / 3).astype(np.float64)
        px = np.concatenate([64.0 * uv + 2 ** 15, valid], -1).astype(np.uint16)
        write_png(os.path.join(root, "training", "flow_occ", f"{i:06d}_10.png"), px)


def kitti_flows(model, config, root: str, iters: int):
    """The validator's flows over the KITTI split under ``root``, pair by
    pair (bucketed and cropped as ``validate_kitti`` does)."""
    from raft_tpu_torch.data.datasets import KITTI
    from raft_tpu_torch.evaluation.evaluate import (_crop, _to_device_pair,
                                                    make_forward)

    fwd, _ = make_forward(config, iters, device="cuda")
    val = KITTI(split="training", root=os.path.join(root, "KITTI"))
    out = []
    for i in range(len(val)):     # indexing wraps around: no iteration
        img1, img2, _, _ = val[i]
        i1, i2, padder, crop = _to_device_pair(img1, img2, "kitti",
                                               kitti_bucket())
        out.append(padder.unpad(_crop(fwd(model, i1, i2)[1], crop))[0]
                   .cpu().numpy())
    return out


def run_evaluate(argv, pairs: int):
    """One timed ``cli/evaluate.main`` run: (metrics, ms per pair with the
    frames' decoding, peak MiB, launches)."""
    from raft_tpu_torch import kernels
    from raft_tpu_torch.cli.evaluate import main as evaluate_main

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = evaluate_main(argv)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / pairs
    return (metrics, ms, torch.cuda.max_memory_allocated() / 2 ** 20,
            kernels.launch_counts())


def expected_launches(**counts):
    """Every kernel's launch count: those given, 0 for the rest."""
    names = ("corr_lookup", "corr_scatter", "gru_gates", "gru_blend",
             "gru_gates_bwd", "gru_blend_bwd", "corr_alt")
    return {k: counts.get(k, 0) for k in names}


def sintel_submission(model, config, root: str, out: str,
                      device: str = "cuda"):
    """``create_sintel_submission`` with warm start over the Sintel test
    layout under ``root``; returns the written flows by path (relative to
    ``out``) and, per pair, the (low-res flow, forward-interpolated init)
    that ``forward_interpolate`` saw and gave."""
    from raft_tpu_torch.data.frame_utils import read_flow
    from raft_tpu_torch.evaluation import evaluate as ev

    warps = []
    interp = ev.forward_interpolate

    def recording(flow):
        init = interp(flow)
        warps.append((flow, init))
        return init

    ev.forward_interpolate = recording
    try:
        ev.create_sintel_submission(model, config, warm_start=True,
                                    output_path=out, data_root=root,
                                    device=device)
    finally:
        ev.forward_interpolate = interp
    flows = {}
    for d, _, files in sorted(os.walk(out)):
        for f in sorted(files):
            flows[os.path.relpath(os.path.join(d, f), out)] = read_flow(
                os.path.join(d, f))
    return flows, warps


def check_sintel_chain(subs, frames, models) -> None:
    """Phase 11: the two paths' warm-started submissions over one scene of
    ``frames`` in clean and final. ``subs`` maps "alternate" and
    "materialized" to ``sintel_submission``'s result, ``models`` each to
    its (``fwd_init``, model).

    A cold pair is held within SMALL_TOL. A warm pair starts from the last
    pair's low-res flow, forward-interpolated, so the two paths start from
    inits that differ by the last link's gap. Each warm pair is run again
    by each path from the other's init: from one init, only the lookups
    differ, and each path is held within SMALL_TOL of the other there (the
    gates). The chained gap is then at most the gate plus the materialized
    path's own response to the inits' gap (the triangle inequality), and
    is held to that; the response, K1 alone from two inits, shows how the
    warm-start chain feeds a gap forward, link by link."""
    (flows_a, warps_a), (flows_m, warps_m) = (subs["alternate"],
                                              subs["materialized"])
    pairs = len(frames) - 1
    if sorted(flows_a) != sorted(flows_m) or len(flows_a) != 2 * pairs:
        raise RuntimeError(f"submissions wrote {sorted(flows_a)} and "
                           f"{sorted(flows_m)}")
    from raft_tpu_torch.evaluation.evaluate import _to_device_pair

    (fwd_a, model_a), (fwd_m, model_m) = (models["alternate"],
                                          models["materialized"])
    device = next(model_m.parameters()).device.type
    for k, key in enumerate(sorted(flows_a)):
        j = k % pairs                     # the pair's index in its scene
        a, m = flows_a[key], flows_m[key]
        d = float(np.abs(a - m).max())
        if a.shape != frames[0].shape[:2] + (2,) or not np.isfinite(a).all():
            raise RuntimeError(f"{key}: bad flow")
        if j == 0:
            log(f"[11] {key} (cold): max |flow diff| alternate vs "
                f"materialized {d:.3e} px (tol {SMALL_TOL:g})")
            if not d <= SMALL_TOL:
                raise RuntimeError(f"{key}: alternate disagrees")
            continue
        (low_a, init_a), (low_m, init_m) = warps_a[k - 1], warps_m[k - 1]
        d_low = float(np.abs(low_a - low_m).max())
        d_init = float(np.abs(init_a - init_m).max())
        i1, i2, padder, _ = _to_device_pair(frames[j], frames[j + 1],
                                            "sintel", device=device)

        def run(fwd, model, init):
            flow = fwd(model, i1, i2, init[None])[1]
            return padder.unpad(flow)[0].cpu().numpy()

        m_from_a = run(fwd_m, model_m, init_a)
        a_from_m = run(fwd_a, model_a, init_m)
        gate_a = float(np.abs(a - m_from_a).max())
        gate_m = float(np.abs(a_from_m - m).max())
        d_resp = float(np.abs(m_from_a - m).max())
        # griddata's nearest neighbour copies flow values, so without a
        # flipped neighbour the inits differ by at most the low-res flows
        flipped = d_init > d_low
        log(f"[11] {key} (warm, link {j}): from one init, alternate vs "
            f"materialized {gate_a:.3e} px (the alternate's init) and "
            f"{gate_m:.3e} px (the materialized's) (tol {SMALL_TOL:g}); "
            f"chained {d:.3e} px, bound {d_resp + SMALL_TOL:.3e}: the "
            f"materialized path's response to the inits' gap {d_resp:.3e} px "
            f"+ {SMALL_TOL:g} (low-res flows in {d_low:.3e}, their "
            f"forward-interpolated inits {d_init:.3e}, gain "
            f"{d_resp / max(d_init, 1e-30):.1f}"
            f"{', a nearest neighbour flipped' if flipped else ''})")
        if not (gate_a <= SMALL_TOL and gate_m <= SMALL_TOL
                and d <= d_resp + SMALL_TOL):
            raise RuntimeError(f"{key}: alternate disagrees")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from raft_tpu_torch import kernels
    from raft_tpu_torch.cli.demo import main as demo_main
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.data.png import read_png
    from raft_tpu_torch.evaluation.evaluate import make_forward
    from raft_tpu_torch.kernels import _build
    from raft_tpu_torch.kernels.corr_alt import alt_corr_lookup_cuda
    from raft_tpu_torch.kernels.corr_lookup import (corr_lookup_bwd_plain,
                                                    corr_lookup_cuda,
                                                    corr_scatter_cuda)
    from raft_tpu_torch.kernels.gru import (gru_blend, gru_blend_bwd,
                                            gru_blend_bwd_plain,
                                            gru_blend_plain, gru_gates,
                                            gru_gates_bwd,
                                            gru_gates_bwd_plain,
                                            gru_gates_plain)
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.models.corr import (alt_corr_lookup,
                                            build_corr_pyramid,
                                            corr_lookup_gather)
    from raft_tpu_torch.tools.convert import load_pth, save_pth
    from raft_tpu_torch.training.train_step import make_train_step
    from raft_tpu_torch.training.trainer import train

    # -- 1. device -----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[1] device: {kind} (count {count}); nvidia-smi: {smi}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    log("[1] TF32 off: cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False")

    # -- 2. build ------------------------------------------------------------
    build = _build.library()
    log(f"[2] built {build.path} in {build.seconds:.1f} s")
    for line in build.log.splitlines():
        if "ptxas info" in line:
            log(f"[2]   {line.strip()}")
    # ptxas reports static shared memory only; the lookups' is dynamic
    alt_smem = {r: build.lib.corr_alt_smem_bytes(r) for r in (4, 3)}
    log(f"[2] dynamic shared memory per block: corr_alt (512 threads, one "
        f"block per SM) {alt_smem[4]} B at r=4, {alt_smem[3]} B at r=3 (a "
        "2-stage cp.async ring of 320-row x 32-channel fp32 slabs in "
        "core-matrix layout, the queries' big and small planes of one slab, "
        f"64 (2r+2)^2 fp32 windows); corr_lookup {8 * 4 * 100 * 4} B per 8 warps at r=4 "
        f"and 4 levels (each warp L x (2r+2)^2 fp32 windows); corr_scatter "
        f"{8 * 81 * 4} B at r=4 (8 warps x (2r+1)^2 fp32 cotangents); the "
        "GRU kernels none")
    for name, n_mma in sass_mma_counts(build.path).items():
        log(f"[2] SASS of {name}: {n_mma} tensor-core MMA instructions "
            "(HMMA/HGMMA, by cuobjdump -sass)")
        if "corr_alt" in name and not n_mma:
            raise RuntimeError("corr_alt's products do not run on the "
                               "tensor cores")

    # -- 3. kernels against their plain versions ----------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = {"corr_lookup": 0.0, "gru_gates": 0.0, "gru_blend": 0.0}
    err_bf16 = {"gru_gates": 0.0, "gru_blend": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        pyramid, coords = lookup_inputs(gen, dtype)
        for radius in (4, 3):
            e = max_err(corr_lookup_cuda(pyramid, coords, radius),
                        corr_lookup_gather(pyramid, coords, radius))
            log(f"[3] corr_lookup r={radius} {str(dtype)[6:]} volume: max abs "
                f"err {e:.3e} (tol {LOOKUP_TOL:g})")
            if not e <= LOOKUP_TOL:
                raise RuntimeError("corr_lookup disagrees with its plain version")
            err["corr_lookup"] = max(err["corr_lookup"], e)
        del pyramid
    shape = (1, GRID[0] * GRID[1], 128)
    for dtype in (torch.float32, torch.bfloat16):
        zl, rl, h, ql = (3 * torch.randn(shape, generator=gen, device="cuda")
                         .to(dtype) for _ in range(4))
        z = torch.sigmoid(zl.float()).to(dtype)
        hold_gru("3", {"gru_gates": (gru_gates(zl, rl, h),
                                     gru_gates_plain(zl, rl, h)),
                       "gru_blend": ((gru_blend(z, h, ql),),
                                     (gru_blend_plain(z, h, ql),))},
                 dtype, "(1,7040,128)", err, err_bf16)

    # -- 4. times ------------------------------------------------------------
    pyramid, coords = lookup_inputs(gen, torch.float32)
    e = max_err(lookup_grid_sample(pyramid, coords, 4),
                corr_lookup_gather(pyramid, coords, 4))
    log(f"[4] grid_sample yardstick vs plain lookup: max abs err {e:.3e}")
    nbytes = lookup_bytes(pyramid, coords, 4)
    zl, rl, h, ql = (3 * torch.randn(shape, generator=gen, device="cuda")
                     for _ in range(4))
    z = torch.sigmoid(zl)
    n = zl.numel()
    work = {"corr_lookup": (lambda: corr_lookup_cuda(pyramid, coords, 4),
                            lambda: corr_lookup_gather(pyramid, coords, 4),
                            lambda: lookup_grid_sample(pyramid, coords, 4),
                            nbytes, coords[..., 0].numel() * 4 * 81 * 9),
            "gru_gates": (lambda: gru_gates(zl, rl, h),
                          lambda: gru_gates_plain(zl, rl, h), None,
                          5 * n * 4, 9 * n),
            "gru_blend": (lambda: gru_blend(z, h, ql),
                          lambda: gru_blend_plain(z, h, ql), None,
                          4 * n * 4, 6 * n)}
    times = time_kernels("4", work, smi, 50, 50)
    note_sectors("4", times["corr_lookup"], pyramid, coords, smi)
    for name, (kern, *_) in work.items():
        times[name]["call_ms"] = cuda_ms(kern, 200)
        log(f"[4] {name}: one wrapper call back-to-back "
            f"{times[name]['call_ms']:.4f} ms (events, host included)")
    del pyramid

    # -- 5. end to end -------------------------------------------------------
    frames = synthetic_frames(0, PAIRS + 1)
    cfg_k = RAFTConfig(corr_impl="pallas", gru_impl="fused")
    cfg_p = RAFTConfig(corr_impl="gather", gru_impl="xla")
    model_k = RAFT(cfg_k, torch.Generator().manual_seed(0)).cuda()
    model_p = RAFT(cfg_p).cuda()
    model_p.load_state_dict(model_k.state_dict())
    run_pairs(model_k, cfg_k, frames[:2], ITERS)        # warm-up
    kernels.reset_launch_counts()
    flows_k, ms_k, peak_k = run_pairs(model_k, cfg_k, frames, ITERS)
    launches = kernels.launch_counts()
    per_pair = {k: v / PAIRS for k, v in launches.items()}
    log(f"[5] basic model, pallas+fused, iters={ITERS}: {ms_k:.2f} ms/pair, "
        f"peak {peak_k:.0f} MiB, launches {launches} over {PAIRS} pairs, "
        f"{per_pair} per pair; {smi}")
    want = expected_launches(corr_lookup=ITERS * PAIRS, gru_gates=2 * ITERS * PAIRS,
                       gru_blend=2 * ITERS * PAIRS)
    if launches != want:
        raise RuntimeError(f"main path launches {launches}, want {want}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_pairs(model_k, cfg_k, frames[:2], ITERS)
        wall = (time.perf_counter() - t0) * 1e3
    evs = device_events(prof)
    busy = device_busy_ms(prof)
    log(f"[5] basic model, one pair under the profiler: wall {wall:.2f} ms, "
        f"device busy {busy:.2f} ms, idle share {1 - busy / wall:.3f}; top "
        "device time:")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[5]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:100]}")
    run_pairs(model_p, cfg_p, frames[:2], ITERS)        # warm-up
    flows_p, ms_p, peak_p = run_pairs(model_p, cfg_p, frames, ITERS)
    d_kp = flow_diff(flows_k, flows_p)
    log(f"[5] basic model, gather+xla (plain), iters={ITERS}: {ms_p:.2f} "
        f"ms/pair, peak {peak_p:.0f} MiB; max |flow diff| vs kernels "
        f"{d_kp:.3e} px")
    # The second witness: random weights make the 20-step recurrence
    # chaotic, so the plain path against itself, on frames moved by one
    # ulp, must open a gap of the same order as kernels against plain.
    ulp = [np.nextafter(f, np.float32(np.inf)) for f in frames]
    flows_u, _, _ = run_pairs(model_p, cfg_p, ulp, ITERS)
    d_pp = flow_diff(flows_p, flows_u)
    log(f"[5] basic model, plain vs plain on frames moved by 1 ulp, iters="
        f"{ITERS}: max |flow diff| {d_pp:.3e} px; kernels vs plain "
        f"{d_kp:.3e} px (held to at most 10x the plain-vs-plain gap)")
    if not d_kp <= 10 * d_pp:
        raise RuntimeError("basic model: kernels vs plain at iters="
                           f"{ITERS} exceeds what 1 ulp of input gives")
    step_k, _, _ = run_pairs(model_k, cfg_k, frames, 1)
    step_p, _, _ = run_pairs(model_p, cfg_p, frames, 1)
    d = flow_diff(step_k, step_p)
    log(f"[5] basic model, iters=1: max |flow diff| kernels vs plain {d:.3e} "
        f"px (tol {BASIC_STEP_TOL:g})")
    if not d <= BASIC_STEP_TOL:
        raise RuntimeError("basic model: kernels disagree with plain")
    del model_k, model_p

    fixture = os.path.join(REPO, "tests", "fixtures",
                           "raft-small-cputrained.pth")
    cfg_sk = RAFTConfig(small=True, corr_impl="pallas")
    cfg_sp = RAFTConfig(small=True, corr_impl="gather")
    small_k = load_pth(fixture, cfg_sk).cuda()
    small_p = load_pth(fixture, cfg_sp).cuda()
    run_pairs(small_k, cfg_sk, frames[:2], ITERS)       # warm-up
    kernels.reset_launch_counts()
    sflows_k, sms_k, speak_k = run_pairs(small_k, cfg_sk, frames, ITERS)
    slaunch = kernels.launch_counts()
    sflows_p, sms_p, _ = run_pairs(small_p, cfg_sp, frames, ITERS)
    d = flow_diff(sflows_k, sflows_p)
    log(f"[5] small model (trained fixture), iters={ITERS}: kernel lookup "
        f"{sms_k:.2f} ms/pair (peak {speak_k:.0f} MiB, launches {slaunch}), "
        f"plain {sms_p:.2f} ms/pair; max |flow diff| {d:.3e} px (tol "
        f"{SMALL_TOL:g}); {smi}")
    if not d <= SMALL_TOL or slaunch["corr_lookup"] != ITERS * PAIRS:
        raise RuntimeError("small model: kernel lookup disagrees with plain")

    del small_k, small_p

    # -- 6. backward kernels at the training geometry ------------------------
    B, (Hg, Wg) = TRAIN_B, TRAIN_GRID
    for dtype in (torch.float32, torch.bfloat16):
        pyramid, coords = lookup_inputs(gen, dtype, B, TRAIN_GRID)
        e = max_err(corr_lookup_cuda(pyramid, coords, 4),
                    corr_lookup_gather(pyramid, coords, 4))
        log(f"[6] corr_lookup r=4 {str(dtype)[6:]} volume, B={B}, grid "
            f"{Hg}x{Wg}: max abs err {e:.3e} (tol {LOOKUP_TOL:g})")
        if not e <= LOOKUP_TOL:
            raise RuntimeError("corr_lookup disagrees with its plain version")
        err["corr_lookup"] = max(err["corr_lookup"], e)
        g = torch.randn((B, Hg, Wg, 4 * 81), generator=gen, device="cuda")
        got = corr_scatter_cuda(g, pyramid, coords, 4)
        again = corr_scatter_cuda(g, pyramid, coords, 4)
        want = corr_lookup_bwd_plain(g, [v.float() for v in pyramid], coords, 4)
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        e = max(max_err(a, w) for a, w in zip(got, want))
        if dtype == torch.float32:
            ok = e <= SCATTER_TOL
            err["corr_scatter"] = e
            bound = f"tol {SCATTER_TOL:g}"
        else:
            # one rounding of the fp32 gradient: half a bf16 ulp
            ok = all(bool(((a.float() - w).abs()
                           <= 2 ** -8 * w.abs() + SCATTER_TOL).all())
                     for a, w in zip(got, want))
            err_bf16["corr_scatter"] = e
            bound = "bound half a bf16 ulp of the fp32 plain VJP + 1e-5"
        log(f"[6] corr_scatter r=4 {str(dtype)[6:]} volume, B={B}, grid "
            f"{Hg}x{Wg}: max abs err {e:.3e} vs the plain VJP ({bound}); two "
            f"calls bitwise equal: {bitwise}")
        if not (ok and bitwise):
            raise RuntimeError("corr_scatter disagrees with its plain version")
        del pyramid, got, again, want
    for dtype in (torch.float32, torch.bfloat16):
        zl, rl, h, ql, dz, drh, g, z = gru_bwd_inputs(gen, dtype)
        hold_gru("6", {"gru_gates": (gru_gates(zl, rl, h),
                                     gru_gates_plain(zl, rl, h)),
                       "gru_blend": ((gru_blend(z, h, ql),),
                                     (gru_blend_plain(z, h, ql),)),
                       "gru_gates_bwd": (gru_gates_bwd(zl, rl, h, dz, drh),
                                         gru_gates_bwd_plain(zl, rl, h, dz,
                                                             drh)),
                       "gru_blend_bwd": (gru_blend_bwd(z, h, ql, g),
                                         gru_blend_bwd_plain(z, h, ql, g))},
                 dtype, str(tuple(h.shape)), err, err_bf16)

    pyramid, coords = lookup_inputs(gen, torch.float32, B, TRAIN_GRID)
    g = torch.randn((B, Hg, Wg, 4 * 81), generator=gen, device="cuda")
    leaves = [v.clone().requires_grad_() for v in pyramid]
    ref = lookup_grid_sample(leaves, coords, 4)
    e = max(max_err(a, w) for a, w in zip(
        torch.autograd.grad(ref, leaves, g, retain_graph=True),
        corr_lookup_bwd_plain(g, pyramid, coords, 4)))
    log(f"[6] grid_sample backward yardstick vs plain VJP: max abs err {e:.3e}")
    zl, rl, h, ql, dz, drh, gz, z = gru_bwd_inputs(gen, torch.float32)
    n = h.numel()
    train_work = {
        "corr_lookup": (lambda: corr_lookup_cuda(pyramid, coords, 4),
                        lambda: corr_lookup_gather(pyramid, coords, 4),
                        lambda: lookup_grid_sample(pyramid, coords, 4),
                        lookup_bytes(pyramid, coords, 4),
                        coords[..., 0].numel() * 4 * 81 * 9),
        "corr_scatter": (lambda: corr_scatter_cuda(g, pyramid, coords, 4),
                         lambda: corr_lookup_bwd_plain(g, pyramid, coords, 4),
                         lambda: torch.autograd.grad(ref, leaves, g,
                                                     retain_graph=True),
                         scatter_bytes(pyramid, coords, 4),
                         coords[..., 0].numel() * 4 * 100 * 8),
        "gru_gates": (lambda: gru_gates(zl, rl, h),
                      lambda: gru_gates_plain(zl, rl, h), None,
                      5 * n * 4, 9 * n),
        "gru_blend": (lambda: gru_blend(z, h, ql),
                      lambda: gru_blend_plain(z, h, ql), None,
                      4 * n * 4, 6 * n),
        "gru_gates_bwd": (lambda: gru_gates_bwd(zl, rl, h, dz, drh),
                          lambda: gru_gates_bwd_plain(zl, rl, h, dz, drh),
                          None, 8 * n * 4, 16 * n),
        "gru_blend_bwd": (lambda: gru_blend_bwd(z, h, ql, gz),
                          lambda: gru_blend_bwd_plain(z, h, ql, gz), None,
                          7 * n * 4, 12 * n)}
    train_times = time_kernels("6", train_work, smi, 20, 10,
                               " at the training geometry")
    note_sectors("6", train_times["corr_lookup"], pyramid, coords, smi)
    del pyramid, leaves, ref, zl, rl, h, ql, dz, drh, gz, z

    # -- 7. training through trainer.train -----------------------------------
    cfg_k = RAFTConfig(corr_impl="pallas", gru_impl="fused")
    cfg_p = RAFTConfig(corr_impl="gather", gru_impl="xla")
    batches = [train_batch(seed) for seed in range(TRAIN_STEPS)]
    with tempfile.TemporaryDirectory() as tmp:
        tc = train_config(name="chip-smoke", num_steps=TRAIN_STEPS,
                          checkpoint_dir=os.path.join(tmp, "ckpt"),
                          log_dir=os.path.join(tmp, "runs"))
        loader = TimedLoader(batches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        state = train(cfg_k, tc, loader=loader, device="cuda")
        train_launches = kernels.launch_counts()
        peak_train = torch.cuda.max_memory_allocated() / 2 ** 20
        step_ms = [1e3 * (b - a) for a, b in zip(loader.marks, loader.marks[1:])]
        ms_step = float(np.median(step_ms[1:]))
        per_step = {k: v / TRAIN_STEPS for k, v in train_launches.items()}
        log(f"[7] train(): basic model, chairs recipe (B={TRAIN_B}, "
            f"{TRAIN_HW[0]}x{TRAIN_HW[1]}, iters={TRAIN_ITERS}, fp32, batch "
            f"norms trained), pallas+fused, {TRAIN_STEPS} steps: "
            f"{ms_step:.2f} ms per step (median of steps 2-{len(step_ms)}; "
            f"all {', '.join(f'{x:.2f}' for x in step_ms)} ms), "
            f"{TRAIN_B / ms_step * 1e3:.2f} pairs/s, peak {peak_train:.0f} "
            f"MiB; launches {train_launches}, {per_step} per step; {smi}")
        want = expected_launches(corr_lookup=TRAIN_ITERS, corr_scatter=TRAIN_ITERS,
                           gru_gates=2 * TRAIN_ITERS, gru_blend=2 * TRAIN_ITERS,
                           gru_gates_bwd=2 * TRAIN_ITERS,
                           gru_blend_bwd=2 * TRAIN_ITERS)
        if per_step != want:
            raise RuntimeError(f"training launches {per_step} per step, "
                               f"want {want}")
        reloaded = load_pth(os.path.join(tmp, "ckpt", "chip-smoke.pth"), cfg_k)
        for k, v in state.model.state_dict().items():
            if not torch.equal(reloaded.state_dict()[k], v.cpu()):
                raise RuntimeError(f"the written .pth differs at {k}")
        log("[7] the .pth that train() wrote loads back with strict=True "
            "and equals the trained weights")

    from torch.profiler import ProfilerActivity, profile

    step_fn = make_train_step(cfg_k, tc)
    step_fn(state, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        metrics = step_fn(state, batches[1])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = device_events(prof)
    busy = device_busy_ms(prof)
    train_idle = 1 - busy / wall
    log(f"[7] one train step under the profiler: wall {wall:.2f} ms, device "
        f"busy {busy:.2f} ms (union of kernel intervals; their summed time "
        f"{sum(e.self_device_time_total for e in evs) / 1e3:.2f} ms), idle "
        f"share {train_idle:.3f}; loss "
        f"{float(metrics['loss']):.4f}; top device time:")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"[7]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:100]}")
    del state, step_fn, prof

    # -- 8. one step, kernels against plain ----------------------------------
    torch.backends.cudnn.deterministic = True
    weights = RAFT(cfg_k, torch.Generator().manual_seed(1)).state_dict()
    batch = {k: v.astype(np.float32) for k, v in batches[0].items()}
    ulp = dict(batch, image1=np.nextafter(batch["image1"], np.float32(np.inf)),
               image2=np.nextafter(batch["image2"], np.float32(np.inf)))
    check_step("basic model, iters=1, kernels vs plain",
               step_grads(cfg_p, weights, batch, 1),
               step_grads(cfg_k, weights, batch, 1),
               step_grads(cfg_p, weights, ulp, 1))
    small_w = load_pth(fixture, cfg_sp).state_dict()
    check_step(f"small model (trained fixture), iters={TRAIN_ITERS}, "
               "kernel lookup vs plain",
               step_grads(cfg_sp, small_w, batch, TRAIN_ITERS),
               step_grads(cfg_sk, small_w, batch, TRAIN_ITERS),
               step_grads(cfg_sp, small_w, ulp, TRAIN_ITERS))
    # At random init the 12-step recurrence is chaotic: one ulp of input
    # moves the gradients by the size of the largest, so this witness
    # cannot fail; the two checks above are the gates.
    plain = step_grads(cfg_p, weights, batch, TRAIN_ITERS)
    gap_kp = step_gap(step_grads(cfg_k, weights, batch, TRAIN_ITERS), plain)
    gap_pp = step_gap(step_grads(cfg_p, weights, ulp, TRAIN_ITERS), plain)
    log(f"[8] basic model, iters={TRAIN_ITERS}: kernels vs plain loss gap "
        f"{gap_kp[0]:.3e}, gradient gap largest {gap_kp[1]:.3e} median "
        f"{gap_kp[2]:.3e}; plain vs plain on frames moved by one ulp: loss "
        f"{gap_pp[0]:.3e}, largest {gap_pp[1]:.3e} median {gap_pp[2]:.3e} "
        "(kernels vs plain held to 10x each)")
    if not all(a <= 10 * b for a, b in zip(gap_kp[:3], gap_pp[:3])):
        raise RuntimeError(f"basic model: kernels vs plain at iters="
                           f"{TRAIN_ITERS} exceeds 10x what 1 ulp of input "
                           "gives")

    torch.backends.cudnn.deterministic = False
    del plain, weights, batch, ulp, small_w

    # -- 9. K5, the on-the-fly lookup, at the KITTI geometries ---------------
    eval_grid = kitti_eval_grid()
    err["corr_alt"] = 0.0
    branches = {}
    for field in FIELDS:
        for grid, where in ((eval_grid, "validate_kitti's, bucketed"),
                            (KITTI_GRID, "the submission writer's")):
            for C, radius in ((256, 4), (128, 3)):
                e, e_k1, br = check_alt(gen, grid, C, radius, where, field)
                err["corr_alt"] = max(err["corr_alt"], e)
                err["corr_lookup"] = max(err["corr_lookup"], e_k1)
                if grid == eval_grid and (C, radius) == (256, 4):
                    branches[field] = br
    # fmaps at three times unit variance, twice the rms the model's encoders
    # give K5 (1.4-1.5, profile_corr_alt.py): the tolerance's absolute part
    # does not grow with them, the dots' rounding does
    err_3x = 0.0
    for field in FIELDS:
        e, e_k1, _ = check_alt(gen, eval_grid, 256, 4,
                               "validate_kitti's, bucketed", field, scale=3.0)
        err_3x = max(err_3x, e)
        err["corr_lookup"] = max(err["corr_lookup"], e_k1)
    tiled, per_query = branches["smooth"]
    if not tiled >= SMOOTH_TILED_MIN * (tiled + per_query):
        raise RuntimeError(f"corr_alt tiled {branch_note(branches['smooth'])}"
                           f" of the smooth field, under {SMOOTH_TILED_MIN:.0%}")
    zl, rl, h, ql, _, _, _, z = gru_bwd_inputs(gen, torch.float32, 1, eval_grid)
    hold_gru("9", {"gru_gates": (gru_gates(zl, rl, h),
                                 gru_gates_plain(zl, rl, h)),
                   "gru_blend": ((gru_blend(z, h, ql),),
                                 (gru_blend_plain(z, h, ql),))},
             torch.float32, f"{tuple(h.shape)} (validate_kitti's)", err,
             err_bf16)
    del zl, rl, h, ql, z
    f1, pyr, coords = alt_inputs(gen, 256, 4, eval_grid)
    g = torch.randn((1, *eval_grid, 4 * 81), generator=gen, device="cuda")
    grads = {}
    for name, fn in (("kernel", alt_corr_lookup_cuda),
                     ("plain", alt_corr_lookup)):
        leaves = [t.clone().requires_grad_() for t in [f1, coords, *pyr]]
        grads[name] = torch.autograd.grad(fn(leaves[0], leaves[2:], leaves[1],
                                             4), leaves, g)
    e = max(max_err(a, b) / float(b.abs().max())
            for a, b in zip(grads["kernel"], grads["plain"]))
    log(f"[9] AltCorrLookup gradients (fmap1, 4 levels, coords), grid "
        f"{eval_grid[0]}x{eval_grid[1]}, vs plain autograd: largest gap "
        f"{e:.3e} of each one's largest (tol 1e-5)")
    if not e <= 1e-5:
        raise RuntimeError("AltCorrLookup's gradients disagree with autograd")
    del grads, leaves
    del f1, pyr, coords
    alt_times = {}
    for field in FIELDS:
        f1, pyr, coords = alt_inputs(gen, 256, 4, eval_grid, field=field)
        nbytes, ops = alt_cost(f1, pyr, coords, 4)
        t = alt_times[field] = time_kernels(
            "9", {"corr_alt": (lambda: alt_corr_lookup_cuda(f1, pyr, coords, 4),
                               lambda: alt_corr_lookup(f1, pyr, coords, 4),
                               None, nbytes, ops)},
            smi, 50, 10, f" at validate_kitti's geometry (grid {eval_grid[0]}x"
            f"{eval_grid[1]}, N = {eval_grid[0] * eval_grid[1]}), {field} "
            "field")["corr_alt"]
        t["bound"], t["bound_fp32"] = alt_bound(nbytes, ops)
        t["branches"] = branches[field]
        log(f"[9] corr_alt, {field} field: bound restated for tensor cores "
            f"{t['bound'][0]:.4f} ms by {t['bound'][1]} ({nbytes / 1e6:.2f} MB "
            f"at 3.35 TB/s; {3 * ops / 1e9:.3f} GFLOP of TF32 products at 495 "
            f"TFLOP/s), fp32 figure {t['bound_fp32'][0]:.4f} ms ({ops / 1e9:.3f}"
            f" GFLOP at 67 TFLOP/s); kernel {t['ms']:.4f} ms L2 cold, "
            f"{t['bound'][0] / t['ms']:.1%} of the bound; "
            f"{branch_note(t['branches'])}; {smi}")
        del f1, pyr, coords
    f1, pyr, coords = alt_inputs(gen, 256, 4, eval_grid)
    flush = l2_flusher()
    mat_pyr = build_corr_pyramid(f1, pyr[0])
    mat_build_ms = kernel_ms(lambda: build_corr_pyramid(f1, pyr[0]), 10,
                             flush=flush)
    # the same by CUDA events around back-to-back calls, each after a flush,
    # less the flushes alone: a reading that owes nothing to the profiler
    mat_build_ev = (cuda_ms(lambda: (flush(), build_corr_pyramid(f1, pyr[0])),
                            20, 3) - cuda_ms(flush, 20, 3))
    mat_k1_ms = kernel_ms(lambda: corr_lookup_cuda(mat_pyr, coords, 4), 50,
                          flush=flush)
    log(f"[9] the materialized path K5 replaces, same fmaps (iid field): "
        f"all-pairs volume and pooling {mat_build_ms:.4f} ms once per pair "
        f"({mat_build_ev:.4f} ms by CUDA events less the flushes), "
        f"corr_lookup {mat_k1_ms:.4f} ms per step (profiler, L2 cold); per "
        f"KITTI pair at iters={KITTI_ITERS}: K5 {KITTI_ITERS} x "
        f"{alt_times['smooth']['ms']:.4f} = "
        f"{KITTI_ITERS * alt_times['smooth']['ms']:.3f} ms (smooth field), "
        f"{KITTI_ITERS * alt_times['iid']['ms']:.3f} ms (iid), materialized "
        f"{mat_build_ms + KITTI_ITERS * mat_k1_ms:.3f} ms; {smi}")
    del f1, pyr, coords, mat_pyr

    with tempfile.TemporaryDirectory() as tmp:
        # -- 10. evaluation through cli/evaluate.main, KITTI layout ----------
        write_kitti(os.path.join(tmp, "KITTI"))
        weights_path = os.path.join(tmp, "basic-seed0.pth")
        save_pth(RAFT(RAFTConfig(), torch.Generator().manual_seed(0)),
                 weights_path)
        argv = ["--model", weights_path, "--dataset", "kitti", "--data_root",
                tmp, "--corr_impl", "pallas", "--gru_impl", "fused"]
        n_steps = KITTI_ITERS * KITTI_PAIRS
        evals = {}
        for name, extra, want in (
                ("alternate", ["--alternate_corr"],
                 expected_launches(corr_alt=n_steps, gru_gates=2 * n_steps,
                             gru_blend=2 * n_steps)),
                ("materialized", [],
                 expected_launches(corr_lookup=n_steps, gru_gates=2 * n_steps,
                             gru_blend=2 * n_steps))):
            run_evaluate(argv + extra, KITTI_PAIRS)           # warm-up
            evals[name], branches[name] = k5_branches(
                lambda: run_evaluate(argv + extra, KITTI_PAIRS), "cuda")
            metrics, ms, peak, counts = evals[name]
            log(f"[10] cli/evaluate.main --dataset kitti {' '.join(extra)} "
                f"--corr_impl pallas --gru_impl fused, basic model (seeded "
                f"random weights), {KITTI_PAIRS} pairs 375x1242 (bucketed to "
                f"{8 * eval_grid[0]}x{8 * eval_grid[1]}), iters={KITTI_ITERS}: "
                f"{ms:.2f} ms/pair (PNG "
                f"decoding and weight loading included), peak {peak:.0f} "
                f"MiB, launches {counts}; metrics {metrics}; corr_alt "
                f"{branch_note(branches[name])}; {smi}")
            if counts != want:
                raise RuntimeError(f"{name} path launches {counts}, want {want}")
            if not all(np.isfinite(v) for v in metrics.values()):
                raise RuntimeError(f"{name} path: metrics not finite")
        cfg_ka = RAFTConfig(alternate_corr=True, corr_impl="pallas",
                            gru_impl="fused")
        cfg_km = RAFTConfig(corr_impl="pallas", gru_impl="fused")
        basic = {c: load_pth(weights_path, c).cuda() for c in (cfg_ka, cfg_km)}
        fwd_ms = {}
        for name, c in (("alternate", cfg_ka), ("materialized", cfg_km)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kitti_flows(basic[c], c, tmp, KITTI_ITERS)
            torch.cuda.synchronize()
            fwd_ms[name] = (time.perf_counter() - t0) * 1e3 / KITTI_PAIRS
        d = flow_diff(*(kitti_flows(basic[c], c, tmp, 1)
                        for c in (cfg_ka, cfg_km)))
        log(f"[10] validator flows, forward and copy only: alternate "
            f"{fwd_ms['alternate']:.2f} ms/pair, materialized "
            f"{fwd_ms['materialized']:.2f} ms/pair (iters={KITTI_ITERS}); "
            f"basic model after one step, alternate vs materialized: max "
            f"|flow diff| {d:.3e} px (tol {BASIC_STEP_TOL:g})")
        if not d <= BASIC_STEP_TOL:
            raise RuntimeError("alternate path disagrees with materialized")
        del basic
        cfg_sa = RAFTConfig(small=True, alternate_corr=True,
                            corr_impl="pallas")
        cfg_sm = RAFTConfig(small=True, corr_impl="pallas")
        d = flow_diff(*(kitti_flows(load_pth(fixture, c).cuda(), c, tmp,
                                    KITTI_ITERS) for c in (cfg_sa, cfg_sm)))
        log(f"[10] small model (trained fixture), iters={KITTI_ITERS}, "
            f"alternate (K5) vs materialized (K1): max |flow diff| {d:.3e} px "
            f"(tol {SMALL_TOL:g})")
        if not d <= SMALL_TOL:
            raise RuntimeError("small model: alternate disagrees with "
                               "materialized")

        # -- 11. Sintel submission with warm start over demo-frames ----------
        demo = sorted(glob.glob(os.path.join(REPO, "demo-frames", "*.png")))
        for dstype in ("clean", "final"):
            scene = os.path.join(tmp, "Sintel", "test", dstype, "demo")
            os.makedirs(scene)
            for f in demo:
                shutil.copy(f, scene)
        subs = {}
        for name, c in (("alternate", cfg_sa), ("materialized", cfg_sm)):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            subs[name], branches["sintel_" + name] = k5_branches(
                lambda: sintel_submission(load_pth(fixture, c).cuda(), c, tmp,
                                          os.path.join(tmp, "sub-" + name)),
                "cuda")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / (2 * (len(demo) - 1))
            counts = kernels.launch_counts()
            log(f"[11] create_sintel_submission(warm_start=True), small "
                f"fixture, {name}: {ms:.2f} ms/pair with PNG decoding, "
                f"{len(subs[name][0])} .flo files, launches {counts}; "
                f"corr_alt {branch_note(branches['sintel_' + name])} (the "
                "trained model's flow on real Sintel frames)")
            n_steps = 32 * 2 * (len(demo) - 1)
            want = (expected_launches(corr_alt=n_steps) if name == "alternate"
                    else expected_launches(corr_lookup=n_steps))
            if counts != want:
                raise RuntimeError(f"{name} submission launches {counts}")
        frames = [read_png(f).astype(np.float32) for f in demo]
        check_sintel_chain(subs, frames, {
            name: (make_forward(c, 32, device="cuda")[1],
                   load_pth(fixture, c).cuda())
            for name, c in (("alternate", cfg_sa), ("materialized", cfg_sm))})

    # -- 12. memory at 1080x1920 ---------------------------------------------
    hd_frames = synthetic_frames(3, 2, HD_HW)
    cfg_ha = RAFTConfig(alternate_corr=True, corr_impl="pallas",
                        gru_impl="fused")
    cfg_hm = RAFTConfig(corr_impl="pallas", gru_impl="fused")
    hd = {}
    for name, c in (("alternate", cfg_ha), ("materialized", cfg_hm)):
        model = RAFT(c, torch.Generator().manual_seed(0)).cuda()
        run_pairs(model, c, hd_frames, HD_ITERS)              # warm-up
        kernels.reset_launch_counts()
        _, ms, peak = hd[name] = run_pairs(model, c, hd_frames, HD_ITERS)
        counts = kernels.launch_counts()
        log(f"[12] basic model, 1080x1920, iters={HD_ITERS}, {name}: "
            f"{ms:.2f} ms/pair, peak max_memory_allocated {peak:.0f} MiB, "
            f"launches {counts}; {smi}")
        key = "corr_alt" if name == "alternate" else "corr_lookup"
        if counts[key] != HD_ITERS or counts["corr_alt" if key == "corr_lookup"
                                             else "corr_lookup"]:
            raise RuntimeError(f"1080p {name} launches {counts}")
        del model
    grid_hd = (HD_HW[0] // 8, HD_HW[1] // 8)
    f1, pyr, coords = alt_inputs(gen, 256, 4, grid_hd)
    mat_pyr = build_corr_pyramid(f1, pyr[0])
    k1 = corr_lookup_cuda(mat_pyr, coords, 4)
    e_k1 = max_err(k1, corr_lookup_gather(mat_pyr, coords, 4))
    k5 = alt_corr_lookup_cuda(f1, pyr, coords, 4)
    e_k5 = max_err(k5, k1) / float(k1.abs().max())
    hd_bound, hd_bound_fp32 = alt_bound(*alt_cost(f1, pyr, coords, 4))
    hd_k5_ms = median_kernel_ms(
        lambda: alt_corr_lookup_cuda(f1, pyr, coords, 4), 20, 5, flush=flush)
    hd_k1_ms = median_kernel_ms(
        lambda: corr_lookup_cuda(mat_pyr, coords, 4), 20, 5, flush=flush)
    log(f"[12] 1080x1920 grid {grid_hd[0]}x{grid_hd[1]} (N = "
        f"{grid_hd[0] * grid_hd[1]}, N^2 = {(grid_hd[0] * grid_hd[1]) ** 2:.3e}, "
        f"iid field;"
        f" volume pyramid {sum(v.numel() for v in mat_pyr) * 4 / 2 ** 30:.2f} "
        f"GiB, fmap2 pyramid {sum(v.numel() for v in pyr) * 4 / 2 ** 20:.1f} "
        f"MiB): corr_lookup vs plain {e_k1:.3e} (tol {LOOKUP_TOL:g}); "
        f"corr_alt vs corr_lookup {e_k5:.3e} of the largest (tol "
        f"{ALT_MAT_TOL:g}); corr_alt {hd_k5_ms[0]:.4f} ms ({hd_k5_ms[1]:.4f}"
        f"-{hd_k5_ms[2]:.4f}; bound {hd_bound[0]:.4f} ms by {hd_bound[1]}, "
        f"fp32 figure {hd_bound_fp32[0]:.4f}), corr_lookup {hd_k1_ms[0]:.4f} ms "
        f"({hd_k1_ms[1]:.4f}-{hd_k1_ms[2]:.4f}) (profiler, L2 cold, the "
        f"median of 5 sessions of 20 calls and their range); {smi}")
    if not (e_k1 <= LOOKUP_TOL and e_k5 <= ALT_MAT_TOL):
        raise RuntimeError("the lookups disagree at 1080x1920")
    del f1, pyr, coords, mat_pyr, k1, k5

    # -- 13. the demo CLI on demo-frames, with the port's PNG codec ----------
    t0 = time.perf_counter()
    frame0 = read_png(demo[0])
    decode_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        demo_main(["--model", fixture, "--small", "--path",
                   os.path.join(REPO, "demo-frames"), "--out", tmp,
                   "--corr_impl", "pallas"])
        demo_s = time.perf_counter() - t0
        outs = sorted(glob.glob(os.path.join(tmp, "*.png")))
        back = read_png(outs[0])
        log(f"[13] python -m raft_tpu_torch.cli.demo --path demo-frames "
            f"--small: {len(outs)} flow PNGs in {demo_s:.2f} s, each "
            f"{back.shape} {back.dtype}; one 436x1024 frame decodes in "
            f"{decode_ms:.1f} ms on the host (Paeth rows)")
        if len(outs) != len(demo) - 1 or back.shape != (2 * FRAME_HW[0],
                                                        FRAME_HW[1], 3):
            raise RuntimeError("the demo wrote the wrong images")
        if not np.array_equal(back[:FRAME_HW[0]], frame0):
            raise RuntimeError("the demo's PNG does not hold its frame")

    # -- 14. result ----------------------------------------------------------
    sources = {"corr_lookup": ("raft_tpu_torch/csrc/corr_lookup.cu",
                               "raft_tpu/kernels/corr_pallas.py:177"),
               "gru_gates": ("raft_tpu_torch/csrc/gru.cu",
                             "raft_tpu/kernels/gru_pallas.py:93"),
               "gru_blend": ("raft_tpu_torch/csrc/gru.cu",
                             "raft_tpu/kernels/gru_pallas.py:112"),
               "corr_scatter": ("raft_tpu_torch/csrc/corr_lookup.cu",
                                "raft_tpu/kernels/corr_pallas.py:219"),
               "gru_gates_bwd": ("raft_tpu_torch/csrc/gru.cu",
                                 "raft_tpu/kernels/gru_pallas.py:101"),
               "gru_blend_bwd": ("raft_tpu_torch/csrc/gru.cu",
                                 "raft_tpu/kernels/gru_pallas.py:117")}
    rows = []
    for name, (source, replaces) in sources.items():
        # the inference kernels keep phase 4's times at the inference
        # geometry; every kernel has its training-geometry times (phase 6)
        t = times.get(name, train_times[name])
        tt = train_times[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": train_launches[name],
               "max_abs_err": err[name], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
               "bound_by": t["bound"][1], "library_ms": t["library_ms"],
               "ms_l2_warm": t["ms_l2_warm"],
               "train_geometry": {"ms": tt["ms"], "ms_l2_warm": tt["ms_l2_warm"],
                                  "plain_ms": tt["plain_ms"],
                                  "library_ms": tt["library_ms"],
                                  "bound_ms": tt["bound"][0],
                                  "bound_by": tt["bound"][1],
                                  "mbytes": tt["mbytes"]}}
        if name in times:
            row["launches_inference"] = launches[name]
            row["call_ms"] = t["call_ms"]
        if name in err_bf16:
            row["max_abs_err_bf16"] = err_bf16[name]
        if name == "corr_lookup":
            row.update(sector_mbytes=t["sector_mbytes"],
                       sector_ms=t["sector_ms"])
            row["train_geometry"].update(
                sector_mbytes=tt["sector_mbytes"], sector_ms=tt["sector_ms"])
        rows.append(row)
    # K5: launches from the evaluation path's run (phase 10), times at that
    # path's geometry (phase 9) on the smooth field, the iid field's beside
    # them, with the materialized path and the branch shares
    t, ti = alt_times["smooth"], alt_times["iid"]

    def share(br):
        return br[0] / max(br[0] + br[1], 1)

    rows.append({"name": "corr_alt", "route": "cuda",
                 "source": "raft_tpu_torch/csrc/corr_alt.cu",
                 "replaces": "raft_tpu/kernels/corr_alt_pallas.py:95",
                 "launches": evals["alternate"][3]["corr_alt"],
                 "max_abs_err": err["corr_alt"],
                 "max_abs_err_3x_fmaps": err_3x, "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                 "bound_by": t["bound"][1], "library_ms": None,
                 "ms_l2_warm": t["ms_l2_warm"], "mbytes": t["mbytes"],
                 "field": "smooth", "grid": list(eval_grid),
                 "bound_fp32_ms": t["bound_fp32"][0],
                 "tiled_share": share(t["branches"]),
                 "iid_field": {"ms": ti["ms"], "ms_l2_warm": ti["ms_l2_warm"],
                               "plain_ms": ti["plain_ms"],
                               "bound_ms": ti["bound"][0],
                               "bound_by": ti["bound"][1],
                               "bound_fp32_ms": ti["bound_fp32"][0],
                               "tiled_share": share(ti["branches"])},
                 "tiled_share_kitti_eval": share(branches["alternate"]),
                 "tiled_share_sintel": share(branches["sintel_alternate"]),
                 "materialized_build_ms": mat_build_ms,
                 "materialized_build_ms_events": mat_build_ev,
                 "materialized_k1_ms": mat_k1_ms,
                 "hd_1080x1920": {"ms_median_range": list(hd_k5_ms),
                                  "bound_ms": hd_bound[0],
                                  "bound_fp32_ms": hd_bound_fp32[0],
                                  "k1_ms_median_range": list(hd_k1_ms),
                                  "ms_per_pair": {k: v[1] for k, v in hd.items()},
                                  "peak_mib": {k: v[2] for k, v in hd.items()}}})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
