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
6. print the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
   the ``{"ok": true, "device": ...}`` line.

Exits non-zero, printing no result, when there is no CUDA device.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
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


def kernel_ms(fn, reps: int = 50, flush=None):
    """Device milliseconds per call of ``fn``: the sum of the device time of
    everything it ran on the card, from ``torch.profiler``, over ``reps``
    calls after a warm-up. With ``flush`` (a device-to-device copy larger
    than the 50 MB L2), each call finds the L2 cold; the copies' own time
    is left out. Raises if the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in device_events(prof)
             if not e.key.startswith("Memcpy DtoD"))
    if not us > 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return us / reps / 1e3


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# phase 3-4 inputs and yardsticks
# ---------------------------------------------------------------------------

def lookup_inputs(gen: torch.Generator, dtype: torch.dtype):
    """The main path's pyramid (1, 7040, Hl, Wl) and coords (1, 55, 128, 2):
    grid + random flow, with a tenth of the queries far outside the image."""
    H, W = GRID
    N = H * W
    vol = torch.randn((1, N, H, W), generator=gen, device="cuda")
    pyramid = [vol]
    for _ in range(3):
        pyramid.append(F.avg_pool2d(pyramid[-1], 2, stride=2))
    pyramid = [v.to(dtype).contiguous() for v in pyramid]
    ys, xs = torch.meshgrid(torch.arange(H, device="cuda", dtype=torch.float32),
                            torch.arange(W, device="cuda", dtype=torch.float32),
                            indexing="ij")
    coords = torch.stack([xs, ys], -1)[None]
    coords = coords + 12.0 * torch.randn(coords.shape, generator=gen,
                                         device="cuda")
    far = torch.rand((1, H, W, 1), generator=gen, device="cuda") < 0.1
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

def synthetic_frames(seed: int, n: int):
    """``n`` frames of a smooth random texture, each shifted by (2, 3) px
    from the last, as (436, 1024, 3) float32 in [0, 255]."""
    H, W = FRAME_HW
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from raft_tpu_torch import kernels
    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.kernels import _build
    from raft_tpu_torch.kernels.corr_lookup import corr_lookup_cuda
    from raft_tpu_torch.kernels.gru import (gru_blend, gru_blend_plain,
                                            gru_gates, gru_gates_plain)
    from raft_tpu_torch.models import RAFT
    from raft_tpu_torch.models.corr import corr_lookup_gather
    from raft_tpu_torch.tools.convert import load_pth

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
        "windows); gru_gates, gru_blend none")

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
        pairs = {"gru_gates": (gru_gates(zl, rl, h), gru_gates_plain(zl, rl, h)),
                 "gru_blend": ((gru_blend(z, h, ql),), (gru_blend_plain(z, h, ql),))}
        for name, (got, want) in pairs.items():
            e = max(max_err(g, w) for g, w in zip(got, want))
            if dtype == torch.float32:
                ok = e <= GRU_TOL
                err[name] = e
                bound = f"tol {GRU_TOL:g}"
            else:
                # one bf16 rounding of the same fp32 value may land one ulp
                # apart: |diff| <= 2^-7 * max(|plain|, 1)
                ok = all(bool(((g.float() - w.float()).abs()
                               <= 2 ** -7 * w.float().abs().clamp(min=1)).all())
                         for g, w in zip(got, want))
                err_bf16[name] = e
                bound = "bound one bf16 ulp: 2^-7*max(|plain|,1)"
            log(f"[3] {name} {str(dtype)[6:]} (1,7040,128): max abs err "
                f"{e:.3e} ({bound})")
            if not ok:
                raise RuntimeError(f"{name} disagrees with its plain version")

    # -- 4. times ------------------------------------------------------------
    times = {}
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
    src = torch.empty(32 * 2 ** 20, device="cuda")     # 128 MB > L2
    dst = torch.empty_like(src)

    def flush():
        dst.copy_(src)

    for name, (kern, plain, library, nb, ops) in work.items():
        ms = kernel_ms(kern, flush=flush)
        t = times[name] = dict(
            ms=ms, ms_l2_warm=kernel_ms(kern),
            plain_ms=kernel_ms(plain, flush=flush),
            library_ms=(None if library is None
                        else kernel_ms(library, flush=flush)),
            call_ms=cuda_ms(kern, 200), bound=bound_ms(nb, ops))
        lib = ("" if t["library_ms"] is None
               else f", library {t['library_ms']:.4f} ms")
        log(f"[4] {name}: kernel {ms:.4f} ms (profiler, L2 cold; "
            f"{t['ms_l2_warm']:.4f} ms L2 warm), plain {t['plain_ms']:.4f} "
            f"ms{lib}, bound {t['bound'][0]:.4f} ms by {t['bound'][1]} "
            f"({nb / 1e6:.2f} MB); one wrapper call back-to-back "
            f"{t['call_ms']:.4f} ms (events, host included); {smi}")
    del src, dst
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
    want = {"corr_lookup": ITERS * PAIRS, "gru_gates": 2 * ITERS * PAIRS,
            "gru_blend": 2 * ITERS * PAIRS}
    if launches != want:
        raise RuntimeError(f"main path launches {launches}, want {want}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_pairs(model_k, cfg_k, frames[:2], ITERS)
        wall = (time.perf_counter() - t0) * 1e3
    evs = device_events(prof)
    busy = sum(e.self_device_time_total for e in evs) / 1e3
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

    # -- 6. result -----------------------------------------------------------
    sources = {"corr_lookup": ("raft_tpu_torch/csrc/corr_lookup.cu",
                               "raft_tpu/kernels/corr_pallas.py:177"),
               "gru_gates": ("raft_tpu_torch/csrc/gru.cu",
                             "raft_tpu/kernels/gru_pallas.py:93"),
               "gru_blend": ("raft_tpu_torch/csrc/gru.cu",
                             "raft_tpu/kernels/gru_pallas.py:112")}
    rows = []
    for name, (source, replaces) in sources.items():
        t = times[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": err[name], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
               "bound_by": t["bound"][1], "library_ms": t["library_ms"],
               "ms_l2_warm": t["ms_l2_warm"], "call_ms": t["call_ms"]}
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
