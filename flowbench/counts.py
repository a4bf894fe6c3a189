"""Frozen operation and byte counts, and the card's published peaks.

Counted from a configuration's widths and a cell's shapes alone, so a count
is the same whatever implements the work:

- :func:`forward_flops`: one pair's forward pass, the convolutions (two
  operations a multiply-add, ``2·Cin·Cout·kh·kw`` an output pixel) and the
  all-pairs correlation product (``2·N²·C``). Norms, activations, the
  pooling, the window lookups and the upsampling are elementwise and left
  out, so the count is a floor of the work.
- :func:`train_flops`: forward plus backward, three times the forward (the
  backward of a product is two products of its size).
- :func:`lookup_cost`, :func:`scatter_kernel_cost`, :func:`gates_cost`,
  :func:`blend_cost`: one launch of K1 (the correlation window lookup), K3
  (its backward) and K2 (the GRU's gate and blend tails): the bytes the
  algorithm must move (each input byte read once, each output byte written
  once) and its operations, as ``(bytes, operations)``.
  :func:`scatter_cost` is the whole backward with its zero fill, as the
  kernel table in ``PERF.md`` counts it.

K1 reads the in-range part of each query's (2r+2)² window on each level.
Which part is in range depends on where the queries look; with no
``coords`` the queries look where they stand (zero flow).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, dense tensor-core rates and
#: the float32 rate outside the tensor cores, at the 700 W power limit
PEAKS = {"hbm_bytes_per_s": 3.35e12, "bf16_flops": 989e12,
         "tf32_flops": 495e12, "fp32_flops": 67e12}


def _out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def _conv(layers: List, cin: int, cout: int, k, stride: int, pad,
          hw: Tuple[int, int]) -> Tuple[int, int]:
    """Append one conv's operations to ``layers``; return its output size."""
    kh, kw = (k, k) if isinstance(k, int) else k
    ph, pw = (pad, pad) if isinstance(pad, int) else pad
    oh, ow = _out(hw[0], kh, stride, ph), _out(hw[1], kw, stride, pw)
    layers.append(2 * cin * cout * kh * kw * oh * ow)
    return oh, ow


def encoder_flops(small: bool, out_dim: int, hw: Tuple[int, int]) -> int:
    """One image through a feature or context encoder."""
    ops: List[int] = []
    dims = (32, 32, 64, 96) if small else (64, 64, 96, 128)
    hw = _conv(ops, 3, dims[0], 7, 2, 3, hw)
    cin = dims[0]
    for dim, stride in zip(dims[1:], (1, 2, 2)):
        for s in (stride, 1):
            src = hw
            if small:
                p4 = dim // 4
                _conv(ops, cin, p4, 1, 1, 0, src)
                hw = _conv(ops, p4, p4, 3, s, 1, src)
                _conv(ops, p4, dim, 1, 1, 0, hw)
            else:
                hw = _conv(ops, cin, dim, 3, s, 1, src)
                _conv(ops, dim, dim, 3, 1, 1, hw)
            if s != 1:
                _conv(ops, cin, dim, 1, s, 0, src)
            cin = dim
    _conv(ops, cin, out_dim, 1, 1, 0, hw)
    return sum(ops)


def update_flops(arch: Dict, hw8: Tuple[int, int]) -> int:
    """One refinement step of the update block at the 1/8 grid."""
    ops: List[int] = []
    hdim, cdim = arch["hidden_dim"], arch["context_dim"]
    planes = arch["corr_levels"] * (2 * arch["corr_radius"] + 1) ** 2
    if arch["small"]:
        _conv(ops, planes, 96, 1, 1, 0, hw8)
        _conv(ops, 2, 64, 7, 1, 3, hw8)
        _conv(ops, 64, 32, 3, 1, 1, hw8)
        _conv(ops, 128, 80, 3, 1, 1, hw8)
        cin = hdim + cdim + 82
        for _ in range(3):                      # convz, convr, convq
            _conv(ops, cin, hdim, 3, 1, 1, hw8)
        _conv(ops, hdim, 128, 3, 1, 1, hw8)
        _conv(ops, 128, 2, 3, 1, 1, hw8)
    else:
        _conv(ops, planes, 256, 1, 1, 0, hw8)
        _conv(ops, 256, 192, 3, 1, 1, hw8)
        _conv(ops, 2, 128, 7, 1, 3, hw8)
        _conv(ops, 128, 64, 3, 1, 1, hw8)
        _conv(ops, 256, 126, 3, 1, 1, hw8)
        cin = hdim + cdim + 128
        for k, pad in (((1, 5), (0, 2)), ((5, 1), (2, 0))):
            for _ in range(3):
                _conv(ops, cin, hdim, k, 1, pad, hw8)
        _conv(ops, hdim, 256, 3, 1, 1, hw8)
        _conv(ops, 256, 2, 3, 1, 1, hw8)
        _conv(ops, hdim, 256, 3, 1, 1, hw8)     # the mask head
        _conv(ops, 256, 576, 1, 1, 0, hw8)
    return sum(ops)


def forward_flops(arch: Dict, hw: Tuple[int, int], iters: int) -> int:
    """One pair's forward at the ÷8-padded size ``hw``."""
    small = bool(arch["small"])
    hw8 = (hw[0] // 8, hw[1] // 8)
    n = hw8[0] * hw8[1]
    return (2 * encoder_flops(small, arch["fnet_dim"], hw)
            + encoder_flops(small, arch["hidden_dim"] + arch["context_dim"],
                            hw)
            + 2 * n * n * arch["fnet_dim"]
            + iters * update_flops(arch, hw8))


def train_flops(arch: Dict, hw: Tuple[int, int], iters: int) -> int:
    """One pair's forward and backward."""
    return 3 * forward_flops(arch, hw, iters)


def level_shapes(hw8: Tuple[int, int], levels: int) -> List[Tuple[int, int]]:
    shapes = [hw8]
    for _ in range(levels - 1):
        h, w = shapes[-1]
        shapes.append((h // 2, w // 2))
    return shapes


def _span(c: np.ndarray, level: int, size: int, radius: int) -> np.ndarray:
    """Per query, how many of its 2r+2 window columns (or rows) at
    ``level`` lie inside ``size`` (the coordinate clamped as the kernel
    clamps it)."""
    K = 2 * radius + 1
    c = np.clip(c / 2 ** level, -(radius + 2.0), size + radius + 1.0)
    lo = np.floor(c) - radius
    return np.clip(np.minimum(lo + K, size - 1) - np.maximum(lo, 0) + 1,
                   0, None)


def lookup_cost(batch: int, hw8: Tuple[int, int], levels: int, radius: int,
                coords: Optional[np.ndarray] = None) -> Tuple[float, float]:
    """K1: coords (B, H/8, W/8, 2) read once, the output (levels·(2r+1)²
    float32 a query) written once, the in-range window taps of each
    float32 level read once. ``coords``: where the queries look (x, y);
    None is the zero flow."""
    H, W = hw8
    n = batch * H * W
    K = 2 * radius + 1
    if coords is None:
        ys, xs = np.meshgrid(np.arange(H, dtype=np.float64),
                             np.arange(W, dtype=np.float64), indexing="ij")
        cx, cy, mult = xs, ys, batch
    else:
        cx = np.asarray(coords[..., 0], np.float64)
        cy = np.asarray(coords[..., 1], np.float64)
        mult = 1
    taps = 0.0
    for i, (hl, wl) in enumerate(level_shapes(hw8, levels)):
        taps += mult * float((_span(cx, i, wl, radius)
                              * _span(cy, i, hl, radius)).sum())
    nbytes = n * 2 * 4 + n * levels * K * K * 4 + taps * 4
    return nbytes, float(n * levels * K * K * 9)


def scatter_cost(batch: int, hw8: Tuple[int, int], levels: int,
                 radius: int) -> Tuple[float, float]:
    """The lookup's whole backward, as the kernel table counts it: the
    output cotangent and coords read once, the whole float32 volume
    gradient of every level written once (zero outside the windows)."""
    H, W = hw8
    n = batch * H * W
    K = 2 * radius + 1
    vol = sum(n * hl * wl * 4 for hl, wl in level_shapes(hw8, levels))
    return (float(n * levels * K * K * 4 + n * 2 * 4 + vol),
            float(n * levels * (K + 1) ** 2 * 8))


def scatter_kernel_cost(batch: int, hw8: Tuple[int, int], levels: int,
                        radius: int, coords: Optional[np.ndarray] = None
                        ) -> Tuple[float, float]:
    """K3 alone: the program zero-fills the volume gradient with a fill
    kernel of its own, and K3 reads the cotangent and coords once and
    writes each query's in-range window taps once (K1's count with the
    volume written instead of read)."""
    return (lookup_cost(batch, hw8, levels, radius, coords)[0],
            float(batch * hw8[0] * hw8[1] * levels * (2 * radius + 2) ** 2
                  * 8))


def gates_cost(batch: int, hidden: int, hw8: Tuple[int, int],
               elem: int = 4) -> Tuple[float, float]:
    """K2's gates: z and r pre-activations and h in, z and r·h out."""
    n = batch * hidden * hw8[0] * hw8[1]
    return float(5 * n * elem), float(9 * n)


def blend_cost(batch: int, hidden: int, hw8: Tuple[int, int],
               elem: int = 4) -> Tuple[float, float]:
    """K2's blend: z, h and the candidate in, the new h out."""
    n = batch * hidden * hw8[0] * hw8[1]
    return float(4 * n * elem), float(6 * n)


def bound_s(cost: Tuple[float, float], flops_per_s: float) -> float:
    """The least time the card could take: the larger of bytes over the
    HBM bandwidth and operations over ``flops_per_s``."""
    nbytes, ops = cost
    return max(nbytes / PEAKS["hbm_bytes_per_s"], ops / flops_per_s)
