#!/usr/bin/env python3
"""On-card smoke run of raft_tpu_torch, the PyTorch and CUDA port.

    python3 chip_smoke.py            # every phase, on one CUDA card

Phases, each of which fails loudly (nothing is caught):

1. the device: name, count, and ``nvidia-smi``'s name and power limit;
   TF32 is turned off for cuDNN convs and matmuls, so fp32 means fp32;
2. build the kernels from ``raft_tpu_torch/csrc`` (seconds, and
   ``-Xptxas -v``'s register and shared-memory use);
3. hold each kernel against its plain PyTorch version at the main path's
   shapes (the Sintel demo geometry padded to 440x1024: the 1/8 grid is
   55x128, N = 7040, levels 55x128, 27x64, 13x32, 6x16);
4. time each kernel, its plain version and, for the lookup, the reference's
   formulation (one ``F.grid_sample`` per level): device time from
   ``torch.profiler`` with the L2 flushed before each call (and warm, for
   the kernel), and a wrapper call's time with CUDA events (host
   included), beside its bound: the larger of its bytes at 3.35 TB/s and
   its operations at 67 TFLOP/s (the H100 SXM's HBM rate and fp32
   non-tensor-core peak);
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
   ``F.grid_sample`` per level;
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
9. print the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
   the ``{"ok": true, "device": ...}`` line.

Exits non-zero, printing no result, when there is no CUDA device.
"""

from __future__ import annotations

import functools
import json
import os
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


def log(msg: str) -> None:
    print(msg, flush=True)


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
    """Device milliseconds per call of ``fn``: the sum of the device time of
    everything it ran on the card, from ``torch.profiler``, over ``reps``
    calls after a warm-up. With ``flush`` (a device-to-device copy larger
    than the 50 MB L2), each call finds the L2 cold; the copies' own time
    is left out. A profiler session now and then comes back without its
    device events (seen once on the card in some sixty sessions), so the
    measurement is taken again, up to three times; raises if the profiler
    sees no device time in any."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in device_events(prof)
                 if not e.key.startswith("Memcpy DtoD"))
        if us > 0:
            return us / reps / 1e3
        log(f"    torch.profiler recorded no device time (session "
            f"{attempt + 1} of 3)")
    raise RuntimeError("torch.profiler recorded no device time")


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
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


def time_kernels(tag: str, work, smi: str, reps: int, plain_reps: int,
                 where: str = ""):
    """Phases 4 and 6: for each ``name: (kernel, plain, library or None,
    bytes, operations)``, device times L2 cold (a 128 MB copy, more than
    the 50 MB L2, before each call; the copies' own time left out) and,
    for the kernel, L2 warm, beside the bound; logged with the card."""
    src = torch.empty(32 * 2 ** 20, device="cuda")
    dst = torch.empty_like(src)

    def flush():
        dst.copy_(src)

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


def lookup_bytes(pyramid, coords, radius: int) -> float:
    """Bytes this run's lookup must move: the in-range part of every
    (2r+2)² window read once, coords read once, the output written once."""
    K = 2 * radius + 1
    total = coords.numel() * 4 + coords[..., 0].numel() * len(pyramid) * K * K * 4
    for i, vol in enumerate(pyramid):
        Hl, Wl = vol.shape[-2:]

        def span(c, size):
            c = (c / 2 ** i).clamp(-(radius + 2.0), size + radius + 1.0)
            lo = torch.floor(c) - radius
            return ((lo + K).clamp(max=size - 1) - lo.clamp(min=0) + 1).clamp(min=0)

        taps = span(coords[..., 0], Wl) * span(coords[..., 1], Hl)
        total += float(taps.sum()) * vol.element_size()
    return total


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


def gru_bwd_inputs(gen: torch.Generator, dtype: torch.dtype):
    """The training path's GRU operands, (10, 128, 46, 62), forward and
    backward: zl and rl as the strided channel halves of a double-width
    conv output, as the update block hands them at batch 10."""
    shape = (TRAIN_B, 128) + TRAIN_GRID

    def rand(*s):
        return (3 * torch.randn(s, generator=gen, device="cuda")).to(dtype)

    zr = rand(TRAIN_B, 256, *TRAIN_GRID)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from raft_tpu_torch import kernels
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.kernels import _build
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
    from raft_tpu_torch.models.corr import corr_lookup_gather
    from raft_tpu_torch.tools.convert import load_pth
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
    # ptxas reports static shared memory only; the lookup's is dynamic
    smem = {r: 8 * (2 * r + 2) ** 2 * 4 for r in (4, 3)}
    log(f"[2] dynamic shared memory per 256-thread block: corr_lookup "
        f"{smem[4]} B at r=4, {smem[3]} B at r=3 (8 warps x (2r+2)^2 fp32 "
        f"windows); corr_scatter {8 * 81 * 4} B at r=4 (8 warps x (2r+1)^2 "
        "fp32 cotangents); the GRU kernels none")

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
    want = {"corr_lookup": ITERS * PAIRS, "corr_scatter": 0,
            "gru_gates": 2 * ITERS * PAIRS, "gru_blend": 2 * ITERS * PAIRS,
            "gru_gates_bwd": 0, "gru_blend_bwd": 0}
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
                        lambda: corr_lookup_gather(pyramid, coords, 4), None,
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
        want = {"corr_lookup": TRAIN_ITERS, "corr_scatter": TRAIN_ITERS,
                "gru_gates": 2 * TRAIN_ITERS, "gru_blend": 2 * TRAIN_ITERS,
                "gru_gates_bwd": 2 * TRAIN_ITERS,
                "gru_blend_bwd": 2 * TRAIN_ITERS}
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

    # -- 9. result -----------------------------------------------------------
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
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
