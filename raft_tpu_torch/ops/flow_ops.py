"""Flow-field ops (NHWC), port of ``raft_tpu/ops/flow_ops.py``.

Initialization, align-corners bilinear resize, ``upflow8`` and the learned
convex upsampler (``core/raft.py:63-83``, ``core/utils/utils.py:80-82``),
with the batched forms train mode uses on the per-iteration stack and the
subpixel-domain transforms of the fused sequence loss.

Under a ``spatial`` mesh axis (``sp``, a ``parallel.halo.Spatial``) a flow
is this rank's band of rows: the coordinates are the whole image's
(``initialize_flow``'s ``row0``), and the upsamplers take the rows of the
neighbouring bands they read (one each way) through ``parallel.halo``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from raft_tpu_torch.ops.sampling import coords_grid, grid_sample_nhwc
from raft_tpu_torch.parallel.halo import halo


def initialize_flow(batch: int, ht: int, wd: int, device=None,
                    row0: int = 0):
    """coords0, coords1 at 1/8 resolution; flow = coords1 - coords0.
    ``row0``: the first row's index in the whole image (a band's), so the
    lookups index the whole target."""
    coords0 = coords_grid(batch, ht, wd, device=device, row0=row0)
    coords1 = coords_grid(batch, ht, wd, device=device, row0=row0)
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


def upflow8(flow: torch.Tensor, sp=None) -> torch.Tensor:
    """8x bilinear upsample of a (B, H, W, 2) flow field, values scaled by 8
    (the small model, which has no learned mask).

    With ``sp``, ``flow`` is a band of ``h`` rows: output row ``y`` of the
    band samples the whole image's row ``y·(H−1)/(8H−1)`` (align-corners on
    the global H), which lies at most one row past either end of the band
    (the shift stays under 7/8 of a row). The band takes one halo row each
    way and samples it at the global coordinate less the integer row it
    starts on, which leaves the coordinate's bits and so the weights as
    the whole image's."""
    B, H, W, _ = flow.shape
    if sp is None:
        return 8.0 * resize_bilinear_align_corners(flow, (8 * H, 8 * W))
    row0, Hg = sp.band(H)
    ext = halo(flow, 1, 1, sp, dim=1)
    # the band's first row is global row0 - 1, except on the top band,
    # whose zero halo no output reads (its coordinates start at 0)
    base = max(row0 - 1, 0)
    if row0 == 0:
        ext = ext[:, 1:]
    oh, ow = 8 * H, 8 * W
    sy = (Hg - 1) / (8 * Hg - 1) if Hg > 1 else 0.0
    sx = (W - 1) / (ow - 1) if ow > 1 else 0.0
    ys = torch.arange(8 * row0, 8 * row0 + oh, dtype=torch.float32,
                      device=flow.device) * sy - base
    xs = torch.arange(ow, dtype=torch.float32, device=flow.device) * sx
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return 8.0 * grid_sample_nhwc(ext, gx[None].expand(B, oh, ow),
                                  gy[None].expand(B, oh, ow))


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor,
                    sp=None) -> torch.Tensor:
    """Learned convex-combination 8x upsample: flow (B,H,W,2) fp32, mask
    (B,H,W,576) -> (B,8H,8W,2) fp32.

    The 576 mask channels factor as c = k·64 + i·8 + j (9 neighbors, 8
    sub-rows, 8 sub-cols), the 9 neighbors run over the 3x3 window row-major
    with zero padding, and the softmax over them runs in fp32. Output pixel
    (8h+i, 8w+j) = sum_k softmax(mask)[k,i,j] · 8·flow[h+dy_k, w+dx_k],
    accumulated over k in order as the JAX package does (one frame of
    :func:`convex_upsample_batched_raw`, as there).
    """
    B, H, W, _ = flow.shape
    return subpixel_to_standard(
        convex_upsample_batched_raw(flow[None], mask[None], sp), H, W)[0]


def convex_upsample_batched_raw(flow: torch.Tensor, mask: torch.Tensor,
                                sp=None) -> torch.Tensor:
    """Convex 8x upsample of a stack of iterations, in the subpixel domain:
    flow (T, B, H, W, 2) fp32, mask (T, B, H, W, 576) -> (T, B, 2, 64, H*W)
    fp32, subpixel s = 8i + j on dim 3 and n = W·h + w on dim 4.
    :func:`subpixel_to_standard` finishes the layout; the fused sequence
    loss meets the stack here, so the (T, B, 8H, 8W, 2) stack never
    materializes. The convex combination is 9 shifted multiply-adds, in the
    JAX package's order. With ``sp`` the flow is a band, padded with a row
    of each neighbouring band (zeros past the image's edges)."""
    T, B, H, W, _ = flow.shape
    HW = H * W
    m = mask.float().reshape(T, B, HW, 9, 64).permute(0, 1, 3, 4, 2)
    w9 = torch.softmax(m, dim=2)                          # (T,B,9,64,HW)
    if sp is None:
        fp = F.pad(8.0 * flow.float(), (0, 0, 1, 1, 1, 1))
    else:
        fp = F.pad(halo(8.0 * flow.float(), 1, 1, sp, dim=2),
                   (0, 0, 1, 1))
    up = None
    for k in range(9):
        dy, dx = divmod(k, 3)
        sh = fp[:, :, dy:dy + H, dx:dx + W, :]            # (T,B,H,W,2)
        sh = sh.permute(0, 1, 4, 2, 3).reshape(T, B, 2, 1, HW)
        term = w9[:, :, k, None] * sh
        up = term if up is None else up + term
    return up


def subpixel_to_standard(up: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(T, B, 2, 64, H*W) subpixel-domain stack -> (T, B, 8H, 8W, 2)."""
    T, B = up.shape[:2]
    up = up.reshape(T, B, 2, 8, 8, H, W)
    up = up.permute(0, 1, 5, 3, 6, 4, 2)        # (t,b,h,i,w,j,c)
    return up.reshape(T, B, 8 * H, 8 * W, 2)


def standard_to_subpixel(x: torch.Tensor) -> torch.Tensor:
    """(B, 8H, 8W, C) -> (B, C, 64, H*W), the inverse image-side transform
    of :func:`subpixel_to_standard`, for targets and masks that meet the
    upsampler's raw output in its own domain (the fused loss)."""
    B, H8, W8, C = x.shape
    H, W = H8 // 8, W8 // 8
    x = x.reshape(B, H, 8, W, 8, C)             # (b,h,i,w,j,c)
    x = x.permute(0, 5, 2, 4, 1, 3)             # (b,c,i,j,h,w)
    return x.reshape(B, C, 64, H * W)


def upflow8_batched(flow: torch.Tensor, sp=None) -> torch.Tensor:
    """:func:`upflow8` over a (T, B, H, W, 2) iteration stack at once."""
    T, B, H, W, _ = flow.shape
    out = upflow8(flow.reshape(T * B, H, W, 2), sp)
    return out.reshape(T, B, 8 * H, 8 * W, 2)
