"""Host-side forward interpolation for warm-start flow, port of
``raft_tpu/ops/interp.py``.

Equivalent of ``core/utils/utils.py:26-54``: forward-warp the previous
frame's low-res flow via nearest-neighbor scattered interpolation (scipy
``griddata`` on the host, as in the reference); it runs once per frame in
the Sintel submission writer and the host-state video sessions, off the
hot path. ``forward_interpolate_device`` is the device-resident sessions'
cheaper warp, a scatter on the tensor's own device.
"""

from __future__ import annotations

import numpy as np
import torch


def forward_interpolate(flow: np.ndarray) -> np.ndarray:
    """flow: (H, W, 2) numpy array (x, y channels last). Returns same shape."""
    # imported here: scipy.interpolate costs a second at import, and most
    # processes that import this module (a serving worker) never call it
    from scipy import interpolate

    flow = np.asarray(flow)
    dx, dy = flow[..., 0], flow[..., 1]

    ht, wd = dx.shape
    x0, y0 = np.meshgrid(np.arange(wd), np.arange(ht))

    x1 = (x0 + dx).reshape(-1)
    y1 = (y0 + dy).reshape(-1)
    dx = dx.reshape(-1)
    dy = dy.reshape(-1)

    valid = (x1 > 0) & (x1 < wd) & (y1 > 0) & (y1 < ht)
    x1, y1, dx, dy = x1[valid], y1[valid], dx[valid], dy[valid]

    flow_x = interpolate.griddata((x1, y1), dx, (x0, y0),
                                  method="nearest", fill_value=0)
    flow_y = interpolate.griddata((x1, y1), dy, (x0, y0),
                                  method="nearest", fill_value=0)
    return np.stack([flow_x, flow_y], axis=-1).astype(np.float32)


def forward_interpolate_device(flow: torch.Tensor) -> torch.Tensor:
    """On-device forward warp for device-resident session state
    (``VideoSession(device_state=True)``, the feature-cache warm start):
    each source pixel's flow lands in its rounded target cell, and
    points that leave the frame are dropped (the same validity window as
    the host path).

    Deliberately CHEAPER than the scipy version, not equivalent: cells
    no warped point lands in stay ZERO (a locally cold start — always a
    valid refinement init) instead of being nearest-neighbor filled by
    ``griddata``'s global query, which has no reasonable on-device
    form. Non-finite flow rows fail every validity comparison and land
    nowhere, so a poisoned previous pair degrades to a full cold start
    on the device — the NaN guard the host path does with
    ``np.isfinite`` — without forcing a D2H sync.

    Duplicate targets: the source with the LARGEST row-major index wins
    its cell, on every device and every run. (A plain scatter with
    repeated indices is non-deterministic on CUDA; here the winner is
    chosen by ``scatter_reduce(..., "amax")`` over source indices — an
    integer maximum, order-free — and its flow gathered.) The JAX
    version leaves ties to XLA's scatter; on fields without ties the
    two agree exactly.

    ``flow``: (H, W, 2) float tensor on any device; returns the same
    shape and dtype on the same device. Plain PyTorch: the JAX version
    is an XLA scatter, not a Pallas kernel."""
    flow = torch.as_tensor(flow)
    ht, wd = int(flow.shape[0]), int(flow.shape[1])
    dev = flow.device
    y0, x0 = torch.meshgrid(torch.arange(ht, device=dev),
                            torch.arange(wd, device=dev), indexing="ij")
    x1 = x0 + flow[..., 0]
    y1 = y0 + flow[..., 1]
    valid = (x1 > 0) & (x1 < wd) & (y1 > 0) & (y1 < ht)
    # round half to even, as jnp.round; invalid (and non-finite) points
    # are masked before the integer cast
    xi = torch.where(valid, torch.round(x1), 0).long().clamp(0, wd - 1)
    yi = torch.where(valid, torch.round(y1), 0).long().clamp(0, ht - 1)
    # invalid points target a drop slot past the grid
    idx = torch.where(valid, yi * wd + xi, ht * wd).reshape(-1)
    src = torch.arange(ht * wd, device=dev)
    winner = torch.full((ht * wd + 1,), -1, dtype=torch.long, device=dev)
    winner = winner.scatter_reduce(0, idx, src, "amax")[:ht * wd]
    moved = flow.reshape(-1, 2)[winner.clamp(min=0)]
    out = torch.where((winner >= 0)[:, None], moved, torch.zeros_like(moved))
    return out.reshape(ht, wd, 2)
