"""Shared CLI argument groups, port of ``raft_tpu/cli/_args.py``.

One definition of the per-step ``RAFTConfig`` knobs for every entry point
that builds a model config (demo, evaluate), so the flags and their
plumbing cannot drift apart. Validation of the values lives in
``RAFTConfig.__post_init__``.
"""

from __future__ import annotations

import argparse


def add_corr_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--corr_impl", "--corr-impl", default=None,
                   choices=["gather", "onehot", "onehot_t", "softsel",
                            "softsel_t", "pallas"],
                   help="lookup: 'gather' is the plain version, every other "
                        "name the CUDA kernel (see RAFTConfig)")
    p.add_argument("--corr_dtype", "--corr-dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="correlation-pyramid storage dtype")
    p.add_argument("--scan_unroll", "--scan-unroll", type=int, default=None,
                   help="accepted for compatibility; the loop is not unrolled")
    p.add_argument("--gru_impl", "--gru-impl", default=None,
                   choices=["xla", "fused"],
                   help="'fused' runs the GRU tails in the CUDA kernels")


def corr_overrides(args: argparse.Namespace) -> dict:
    """RAFTConfig kwargs for the flags :func:`add_corr_args` added."""
    return {k: v for k, v in (("corr_impl", args.corr_impl),
                              ("corr_dtype", args.corr_dtype),
                              ("scan_unroll", args.scan_unroll),
                              ("gru_impl", args.gru_impl))
            if v is not None}
