"""Correlation-lookup routes side by side, port of
``raft_tpu/cli/corr_bench.py``: the same inputs through each route, the
difference from the first route of its kind, and the time, forward or
(``--grad``) forward and backward.

Routes:

- ``gather``: the plain lookup (``models.corr.corr_lookup_gather``);
- ``pallas``: the window-lookup kernel K1, with K3 as its backward
  (``kernels.corr_lookup``; the JAX package's name for the route);
- ``alt``: the plain on-the-fly lookup of ``alternate_corr``
  (``models.corr.alt_corr_lookup``);
- ``alt_pallas``: the on-the-fly kernel K5 (``kernels.corr_alt``);
- ``grid_sample``: the yardstick, the reference's lookup (core/corr.py:29-50)
  as one ``F.grid_sample`` per level, the library call ``PERF.md``'s K1 and
  K3 rows cite. The port never calls it.

The JAX package's XLA-only formulations (``onehot``, ``softsel``,
``onehot_t``, ``softsel_t``) have no counterpart here: asked for, they are
reported as failed routes, as an unknown name is, and the run exits 1. On
CPU tensors the kernel routes run their plain versions.

In ``--grad`` mode the comparison covers the primal (the sum of squares)
and every gradient: the volume routes differentiate the pyramid, the
on-the-fly routes the fmaps, so each is held to the first route of its
kind.

    python -m raft_tpu_torch.cli.corr_bench --hw 46 62 [--grad]

(46x62 is the 368x496 chairs crop at stride 8.) Prints a line per route
and, last, one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from raft_tpu_torch.cli._measure import device_info, elapsed_ms

ROUTES = ("gather", "pallas", "alt", "alt_pallas", "grid_sample")
#: the JAX package's routes that are XLA formulations with no port
XLA_ONLY = ("onehot", "softsel", "onehot_t", "softsel_t")


def make_inputs(batch: int, hw, dim: int, seed: int = 0):
    """fmap1, fmap2 (B, H, W, C) N(0, 1) and coords (B, H, W, 2) (the grid
    plus N(0, 4²) px), float32 numpy arrays from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    H, W = hw
    fmap1 = rng.randn(batch, H, W, dim).astype(np.float32)
    fmap2 = rng.randn(batch, H, W, dim).astype(np.float32)
    base = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1)
    coords = (base[None].astype(np.float32)
              + rng.randn(batch, H, W, 2).astype(np.float32) * 4)
    return fmap1, fmap2, coords


def grid_sample_lookup(pyramid, coords, radius: int) -> torch.Tensor:
    """The reference's lookup (core/corr.py:29-50): one bilinear
    ``F.grid_sample`` per level, zeros padding, align_corners=True, in the
    port's x-major channel order. A yardstick only; the port never calls
    it. Its coordinate normalization needs levels of 2 px a side or more."""
    B, H, W, _ = coords.shape
    if min(min(v.shape[-2:]) for v in pyramid) < 2:
        raise ValueError("grid_sample_lookup: a pyramid level under 2 px a "
                         "side (align_corners=True divides by size - 1)")
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


def lookup_routes(fmap1, fmap2, levels: int, radius: int,
                  corr_dtype: torch.dtype = torch.float32) -> dict:
    """``{route: (inputs, fn, kind)}`` over torch tensors ``fmap1``,
    ``fmap2``: ``fn(inputs, coords)`` is the lookup, ``inputs`` the tensors
    it differentiates, ``kind`` ``"volume"`` or ``"fmaps"``."""
    from raft_tpu_torch.kernels.corr_alt import alt_corr_lookup_cuda
    from raft_tpu_torch.kernels.corr_lookup import corr_lookup_cuda
    from raft_tpu_torch.models.corr import (alt_corr_lookup,
                                            build_corr_pyramid,
                                            corr_lookup_gather)
    from raft_tpu_torch.ops.pooling import avg_pool2x2

    pyramid = [v.to(corr_dtype).contiguous()
               for v in build_corr_pyramid(fmap1, fmap2, levels)]
    f2_pyr = [fmap2.contiguous()]
    for _ in range(levels - 1):
        f2_pyr.append(avg_pool2x2(f2_pyr[-1]).contiguous())
    fmaps = [fmap1.contiguous(), *f2_pyr]
    return {
        "gather": (pyramid, lambda v, c: corr_lookup_gather(v, c, radius),
                   "volume"),
        "pallas": (pyramid, lambda v, c: corr_lookup_cuda(v, c, radius),
                   "volume"),
        "alt": (fmaps, lambda v, c: alt_corr_lookup(v[0], v[1:], c, radius),
                "fmaps"),
        "alt_pallas": (fmaps, lambda v, c: alt_corr_lookup_cuda(
            v[0], v[1:], c, radius), "fmaps"),
        "grid_sample": (pyramid,
                        lambda v, c: grid_sample_lookup(v, c, radius),
                        "volume"),
    }


def _runner(inputs, fn, coords, grad: bool):
    """A call of the route and its comparable outputs: the lookup, or the
    sum of squares and the gradients of every input."""
    if not grad:
        return lambda: (fn(inputs, coords),)
    leaves = [t.detach().requires_grad_() for t in inputs]

    def run():
        val = (fn(leaves, coords) ** 2).sum()
        return (val.detach(), *torch.autograd.grad(val, leaves))
    return run


def main(argv=None):
    """Run the routes; returns ``(rows, failed)``: the JSON line's row of
    each route that ran (its ``ms`` a call, its difference from its
    reference route), and the routes that failed or do not exist."""
    p = argparse.ArgumentParser(description="correlation lookup routes")
    p.add_argument("--batch", type=int, default=6)
    p.add_argument("--hw", type=int, nargs=2, default=[46, 62],
                   help="feature-map H W (input/8)")
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--radius", type=int, default=4)
    p.add_argument("--levels", type=int, default=4)
    p.add_argument("--iters", type=int, default=20, help="timed calls")
    p.add_argument("--impls", nargs="+", default=list(ROUTES))
    p.add_argument("--grad", action="store_true",
                   help="time forward and backward (the train step's cost)")
    p.add_argument("--corr_dtype", "--corr-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="the volume routes' pyramid dtype; the on-the-fly "
                        "routes read the fp32 fmaps")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless 'cpu' is asked for")
    args = p.parse_args(argv)

    from raft_tpu_torch.evaluation.evaluate import resolve_device

    dev = resolve_device(args.device)
    B, (H, W) = args.batch, args.hw
    fmap1, fmap2, coords = (torch.from_numpy(a).to(dev) for a in make_inputs(
        B, args.hw, args.dim, args.seed))
    routes = lookup_routes(fmap1, fmap2, args.levels, args.radius,
                           getattr(torch, args.corr_dtype))
    reference = {}          # kind -> (route, comparable outputs)
    failed, rows = [], {}
    for name in args.impls:
        if name not in routes:
            why = ("an XLA formulation of the JAX package with no "
                   "counterpart in the port" if name in XLA_ONLY
                   else f"unknown route (choose from {', '.join(ROUTES)})")
            print(f"{name:>11}: FAILED: {why}", flush=True)
            failed.append(name)
            continue
        inputs, fn, kind = routes[name]
        try:
            run = _runner(inputs, fn, coords, args.grad)
            outs = [o.float() for o in run()]
            ms = elapsed_ms(run, args.iters, dev)
        except Exception as e:  # one failing route must not hide the rest
            print(f"{name:>11}: FAILED {type(e).__name__}: {e}", flush=True)
            failed.append(name)
            continue
        row = {"ms": ms, "mquery_per_s": B * H * W / ms / 1e3, "kind": kind}
        if kind not in reference:
            reference[kind] = (name, outs)
            diff = "reference"
            row.update(reference=name, max_abs_diff=0.0)
        else:
            ref_name, ref = reference[kind]
            if args.grad:
                g, rg = (torch.cat([t.reshape(-1) for t in o[1:]])
                         for o in (outs, ref))
                d = float((g - rg).abs().max()) / max(float(rg.abs().max()),
                                                      1e-9)
                prim = abs(float(outs[0]) - float(ref[0])) / max(
                    abs(float(ref[0])), 1e-9)
                row.update(primal_rel_diff=prim)
                diff = f"max|Δ|={d:.2e} (of the largest) primalΔ={prim:.1e}"
            else:
                d = float((outs[0] - ref[0]).abs().max())
                diff = f"max|Δ|={d:.2e}"
            row.update(reference=ref_name, max_abs_diff=d)
            diff += f" vs {ref_name}"
        rows[name] = row
        print(f"{name:>11}: {ms:8.3f} ms  {row['mquery_per_s']:8.2f} "
              f"Mquery/s  {diff}", flush=True)
    if rows:
        print(f"fastest: {min(rows, key=lambda n: rows[n]['ms'])}",
              flush=True)
    print(json.dumps({"metric": "corr_bench", **device_info(dev),
                      "grad": args.grad, "batch": B, "hw": [H, W],
                      "dim": args.dim, "radius": args.radius,
                      "levels": args.levels, "corr_dtype": args.corr_dtype,
                      "routes": rows, "failed": failed}), flush=True)
    return rows, failed


if __name__ == "__main__":
    # a run where a requested route failed exits nonzero
    _, _failed = main()
    sys.exit(1 if _failed else 0)
