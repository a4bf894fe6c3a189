"""Flow-field ops (NHWC), port of ``raft_tpu/ops/flow_ops.py``.

Initialization, align-corners bilinear resize, ``upflow8`` and the learned
convex upsampler (``core/raft.py:63-83``, ``core/utils/utils.py:80-82``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from raft_tpu_torch.ops.sampling import coords_grid, grid_sample_nhwc


def initialize_flow(batch: int, ht: int, wd: int, device=None):
    """coords0, coords1 at 1/8 resolution; flow = coords1 - coords0."""
    coords0 = coords_grid(batch, ht, wd, device=device)
    coords1 = coords_grid(batch, ht, wd, device=device)
    return coords0, coords1


def resize_bilinear_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C) with align_corners=True semantics:
    output i samples input i*(H_in-1)/(H_out-1)."""
    B, H, W, C = x.shape
    oh, ow = out_hw
    sy = (H - 1) / (oh - 1) if oh > 1 else 0.0
    sx = (W - 1) / (ow - 1) if ow > 1 else 0.0
    ys = torch.arange(oh, dtype=torch.float32, device=x.device) * sy
    xs = torch.arange(ow, dtype=torch.float32, device=x.device) * sx
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return grid_sample_nhwc(x, gx[None].expand(B, oh, ow),
                            gy[None].expand(B, oh, ow))


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """8x bilinear upsample of a (B, H, W, 2) flow field, values scaled by 8
    (the small model, which has no learned mask)."""
    B, H, W, _ = flow.shape
    return 8.0 * resize_bilinear_align_corners(flow, (8 * H, 8 * W))


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Learned convex-combination 8x upsample: flow (B,H,W,2) fp32, mask
    (B,H,W,576) -> (B,8H,8W,2) fp32.

    The 576 mask channels factor as c = k·64 + i·8 + j (9 neighbors, 8
    sub-rows, 8 sub-cols), the 9 neighbors run over the 3x3 window row-major
    with zero padding, and the softmax over them runs in fp32. Output pixel
    (8h+i, 8w+j) = sum_k softmax(mask)[k,i,j] · 8·flow[h+dy_k, w+dx_k],
    accumulated over k in order as the JAX package does.
    """
    B, H, W, _ = flow.shape
    w9 = torch.softmax(mask.float().reshape(B, H, W, 9, 64), dim=3)
    fp = F.pad(8.0 * flow.float(), (0, 0, 1, 1, 1, 1))
    up = torch.zeros(B, H, W, 64, 2, dtype=torch.float32, device=flow.device)
    for k in range(9):
        dy, dx = divmod(k, 3)
        sh = fp[:, dy:dy + H, dx:dx + W, :]                 # (B, H, W, 2)
        up = up + w9[:, :, :, k, :, None] * sh[:, :, :, None, :]
    up = up.reshape(B, H, W, 8, 8, 2).permute(0, 1, 3, 2, 4, 5)
    return up.reshape(B, 8 * H, 8 * W, 2)
