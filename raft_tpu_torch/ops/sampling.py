"""Bilinear sampling primitives (NHWC), port of ``raft_tpu/ops/sampling.py``.

The reference wraps ``torch.nn.functional.grid_sample`` with pixel
coordinates (``core/utils/utils.py:57-71``, align_corners=True, zeros
padding). The JAX package writes that as four flattened-index corner
gathers; this module keeps the same arithmetic, in the same order, so the
two packages agree to rounding.
"""

from __future__ import annotations

import torch


def coords_grid(batch: int, ht: int, wd: int, dtype=torch.float32,
                device=None, row0: int = 0) -> torch.Tensor:
    """Pixel-coordinate grid, shape (batch, ht, wd, 2), last dim (x, y);
    rows numbered from ``row0``."""
    ys, xs = torch.meshgrid(torch.arange(row0, row0 + ht, dtype=dtype,
                                         device=device),
                            torch.arange(wd, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)[None].repeat(batch, 1, 1, 1)


def grid_sample_nhwc(img: torch.Tensor, x: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample ``img`` (B, H, W, C) at pixel coords ``x``/``y``.

    Matches ``F.grid_sample(mode='bilinear', padding_mode='zeros',
    align_corners=True)`` fed pixel coordinates: corners outside the image
    contribute zero, in-bounds corners keep their weights. ``x``/``y`` are
    (B, ...); returns (B, ..., C).
    """
    B, H, W, C = img.shape
    pos_shape = x.shape
    x = x.reshape(B, -1).float()
    y = y.reshape(B, -1).float()

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0

    flat = img.reshape(B, H * W, C)

    def corner(xi, yi, w):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = (yi.clamp(0, H - 1).long() * W
               + xi.clamp(0, W - 1).long())                  # (B, N)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        w = (w * valid.float())[..., None]
        return vals * w.to(vals.dtype)

    out = (corner(x0, y0, (1.0 - wx) * (1.0 - wy))
           + corner(x0 + 1.0, y0, wx * (1.0 - wy))
           + corner(x0, y0 + 1.0, (1.0 - wx) * wy)
           + corner(x0 + 1.0, y0 + 1.0, wx * wy))
    return out.reshape(*pos_shape, C)


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` (B, H, W, C) at ``coords`` (B, ..., 2), last dim (x, y)."""
    return grid_sample_nhwc(img, coords[..., 0], coords[..., 1])
