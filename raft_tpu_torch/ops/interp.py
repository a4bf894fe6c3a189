"""Host-side forward interpolation for warm-start flow, port of
``raft_tpu/ops/interp.py``.

Equivalent of ``core/utils/utils.py:26-54``: forward-warp the previous
frame's low-res flow via nearest-neighbor scattered interpolation (scipy
``griddata`` on the host, as in the reference); it runs once per frame in
the Sintel submission writer, off the hot path.
"""

from __future__ import annotations

import numpy as np
from scipy import interpolate


def forward_interpolate(flow: np.ndarray) -> np.ndarray:
    """flow: (H, W, 2) numpy array (x, y channels last). Returns same shape."""
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


def forward_interpolate_device(flow):
    """The on-device forward warp of ``VideoSession(device_state=True)``;
    its only caller is the serving layer."""
    raise NotImplementedError(
        "forward_interpolate_device serves VideoSession, ROADMAP M11 of the "
        "port")
