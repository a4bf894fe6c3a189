"""Optical-flow visualization: Baker et al. color wheel.

A copy of ``raft_tpu/utils/flow_viz.py`` (numpy only), kept here so the
port imports nothing of the JAX package. That module ports the reference's
``core/utils/flow_viz.py`` (itself from
github.com/tomrunia/OpticalFlow_Visualization, MIT), vectorized over the
channel loop. The fork pins the normalization radius to 3 instead of the
per-frame max (flow_viz.py:128-130) so colors are frame-to-frame consistent
for video output; that behavior stays behind ``rad_max`` (pass ``None``
for the upstream per-frame normalization).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def make_colorwheel() -> np.ndarray:
    """55-color wheel (Baker et al. ICCV 2007), shape (55, 3)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(0, RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(0, YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(0, GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(0, BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


def flow_uv_to_colors(u: np.ndarray, v: np.ndarray,
                      convert_to_bgr: bool = False) -> np.ndarray:
    """(H, W) u/v in wheel-normalized units -> (H, W, 3) uint8."""
    wheel = make_colorwheel()
    ncols = wheel.shape[0]

    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = np.where(k0 + 1 == ncols, 0, k0 + 1)
    f = (fk - k0)[..., None]

    col0 = wheel[k0] / 255.0
    col1 = wheel[k1] / 255.0
    col = (1 - f) * col0 + f * col1

    in_range = (rad <= 1)[..., None]
    col = np.where(in_range, 1 - rad[..., None] * (1 - col), col * 0.75)

    img = np.floor(255 * col).astype(np.uint8)
    return img[:, :, ::-1] if convert_to_bgr else img


def flow_to_image(flow_uv: np.ndarray, clip_flow: Optional[float] = None,
                  convert_to_bgr: bool = False,
                  rad_max: Optional[float] = 3.0) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 visualization.

    ``rad_max=3.0`` is the fork's pinned normalization (flow_viz.py:130);
    ``rad_max=None`` restores upstream per-frame max normalization.
    """
    assert flow_uv.ndim == 3 and flow_uv.shape[2] == 2, flow_uv.shape
    if clip_flow is not None:
        flow_uv = np.clip(flow_uv, 0, clip_flow)
    u, v = flow_uv[:, :, 0], flow_uv[:, :, 1]
    if rad_max is None:
        rad_max = np.sqrt(u ** 2 + v ** 2).max()
    eps = 1e-5
    return flow_uv_to_colors(u / (rad_max + eps), v / (rad_max + eps),
                             convert_to_bgr)
