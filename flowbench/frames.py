"""The cells' inputs: Sintel frames decoded once, the serving pool of frame
pairs and the training batches, all drawn from the run's seed.

- :func:`decode_png` is a frozen zlib-and-NumPy PNG decoder (8- and 16-bit
  gray, gray+alpha, RGB and RGBA, every row filter; no palette or
  interlace), since the card's machine has neither PIL nor cv2.
- :func:`sintel_frames` decodes ``flowbench/frames/*.png`` (ten
  consecutive 436x1024 Sintel frames of the published code's demo) and keeps the
  decoded array in ``build/flowbench/`` inside the checkout, so only the
  first run in a checkout decodes.
- :func:`serve_pool` makes the pool of uint8 pairs that requests draw from:
  each a consecutive pair, resized to the cell's frame size, flipped or
  not, under one photometric gain per pair and channel.
- :func:`train_batches` makes the training batches on the device: a smooth
  random texture as ``image1``, a smooth random flow, and ``image2`` warped
  from ``image1`` by it, valid everywhere.
"""

from __future__ import annotations

import glob
import os
import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flowbench.weights import derive_seed

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE_DIR = os.path.join(os.path.dirname(HERE), "build", "flowbench")

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}


def _unfilter(ftype: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters of ``filt`` (H, W, bpp), one anti-diagonal
    of pixels at a time (each pixel depends on its left, upper and
    upper-left neighbours)."""
    h, w, bpp = filt.shape
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG row filter {int(ftype.max())}")
    if not ftype.any():
        return filt
    w1 = w + 1
    rec = np.zeros(((h + 1) * w1, bpp), np.int16)
    f = filt.reshape(h * w, bpp).astype(np.int16)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        k = ys * w1 + (d - ys)
        a, b, c = rec[k + w1], rec[k + 1], rec[k]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = ftype[ys][:, None]
        if (t != 4).any():
            pred = np.select([t == 0, t == 1, t == 2, t == 3],
                             [0, a, b, (a + b) >> 1], pred)
        rec[k + w1 + 1] = (f[ys * w + d - ys] + pred) & 0xFF
    return rec.reshape(h + 1, w1, bpp)[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG file contents -> (H, W, C) uint8 or uint16 array."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat, pos = None, [], 8
    while pos + 12 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"PNG colour type {ctype}, depth {depth}, "
                         f"interlace {interlace}: not supported")
    ch, nb = _CHANNELS[ctype], depth // 8
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(h, w * ch * nb + 1)
    img = _unfilter(rows[:, 0], rows[:, 1:].reshape(h, w, ch * nb))
    img = img.reshape(h, w * ch * nb)
    if nb == 2:
        img = img.view(">u2").astype(np.uint16)
    return img.reshape(h, w, ch)


def sintel_frames() -> np.ndarray:
    """(10, 436, 1024, 3) uint8, decoded once per checkout."""
    files = sorted(glob.glob(os.path.join(HERE, "frames", "*.png")))
    path = os.path.join(CACHE_DIR, "sintel_frames.npy")
    if os.path.exists(path):
        return np.load(path)
    frames = []
    for f in files:
        with open(f, "rb") as fh:
            frames.append(decode_png(fh.read())[..., :3])
    frames = np.stack(frames)
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        np.save(fh, frames)
    os.replace(tmp, path)
    return frames


def serve_pool(frames: np.ndarray, size: Tuple[int, int], n: int, seed: int,
               device) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``n`` uint8 (H, W, 3) pairs of ``size`` drawn from ``seed``: a
    consecutive pair of ``frames``, a horizontal flip with probability
    one half, and a gain of U(0.8, 1.2) for the pair times U(0.9, 1.1) for
    each channel, the same on both frames."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, 2))
    base = torch.from_numpy(frames).to(device).permute(0, 3, 1, 2).float()
    if tuple(base.shape[-2:]) != tuple(size):
        base = F.interpolate(base, size=tuple(size), mode="bilinear",
                             align_corners=False, antialias=True)
    k = torch.randint(0, len(frames) - 1, (n,), generator=gen, device=device)
    flip = torch.rand((n, 1, 1, 1), generator=gen, device=device) < 0.5
    gain = (0.8 + 0.4 * torch.rand((n, 1, 1, 1), generator=gen,
                                   device=device)) * (
        0.9 + 0.2 * torch.rand((n, 3, 1, 1), generator=gen, device=device))
    out = []
    for first in (base[k], base[k + 1]):
        x = torch.where(flip, first.flip(-1), first) * gain
        out.append(x.round().clamp(0, 255).to(torch.uint8)
                   .permute(0, 2, 3, 1).contiguous().cpu().numpy())
    return [(out[0][i], out[1][i]) for i in range(n)]


def _smooth(shape, grid: Tuple[int, int], size: Tuple[int, int],
            gen: torch.Generator, device) -> torch.Tensor:
    """Gaussian noise on a coarse ``grid``, bicubically upsampled."""
    x = torch.randn(tuple(shape) + tuple(grid), generator=gen, device=device)
    return F.interpolate(x, size=tuple(size), mode="bicubic",
                         align_corners=False)


def train_batches(n_batches: int, batch: int, size: Tuple[int, int],
                  max_flow: float, seed: int,
                  device) -> List[Dict[str, torch.Tensor]]:
    """``n_batches`` batches of ``batch`` distinct pairs: ``image1`` a
    texture of two octaves in [0, 255], a flow of a global shift and a
    smooth field (each up to about ``max_flow`` px), ``image2`` = image1
    sampled at x − flow(x), so that image1(x) ≈ image2(x + flow(x))."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, 4))
    H, W = size
    n = n_batches * batch
    tex = (_smooth((n, 3), (H // 16, W // 16), size, gen, device)
           + 0.5 * _smooth((n, 3), (H // 4, W // 4), size, gen, device))
    lo = tex.amin(dim=(1, 2, 3), keepdim=True)
    hi = tex.amax(dim=(1, 2, 3), keepdim=True)
    image1 = (tex - lo) / (hi - lo) * 255.0
    flow = (0.5 * max_flow * torch.tanh(
        torch.randn((n, 2, 1, 1), generator=gen, device=device))
        + 0.5 * max_flow * torch.tanh(
            _smooth((n, 2), (4, 5), size, gen, device)))
    ys, xs = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(W, device=device, dtype=torch.float32),
                            indexing="ij")
    gx = 2 * (xs - flow[:, 0]) / (W - 1) - 1
    gy = 2 * (ys - flow[:, 1]) / (H - 1) - 1
    image2 = F.grid_sample(image1, torch.stack([gx, gy], -1),
                           mode="bilinear", padding_mode="border",
                           align_corners=True)
    image1 = image1.permute(0, 2, 3, 1).contiguous()
    image2 = image2.permute(0, 2, 3, 1).contiguous()
    flow = flow.permute(0, 2, 3, 1).contiguous()
    valid = torch.ones((n, H, W), device=device)
    return [{"image1": image1[i:i + batch], "image2": image2[i:i + batch],
             "flow": flow[i:i + batch], "valid": valid[i:i + batch]}
            for i in range(0, n, batch)]
