"""PNG and PPM codecs in numpy and ``zlib``: the port's stand-in for PIL and
cv2, which the card's machine does not have.

- :func:`read_png` decodes a non-interlaced PNG of 8- or 16-bit samples,
  gray, gray+alpha, RGB or RGBA, with any of the five row filters, into a
  uint8 or uint16 array: (H, W) for gray, (H, W, C) otherwise, channels in
  file order (R, G, B, A), 16-bit samples big-endian on disk and native in
  the array. Palette and interlaced images, and depths under 8, raise
  ``ValueError``.
- :func:`write_png` encodes such an array with filter 0 (none) on every row.
- :func:`read_ppm` reads a binary PPM (P6), the FlyingChairs frames, and
  :func:`write_ppm` writes one.

Decoding is off the timed path. The Average and Paeth filters depend on the
reconstructed pixel to the left and the row above, so a pixel depends on
its left, upper and upper-left neighbours: the decoder reconstructs one
anti-diagonal of pixels at a time, vectorized across rows.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}     # color type -> samples per pixel
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _chunks(data: bytes, path: str):
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) != crc:
            raise ValueError(f"{path}: corrupt PNG chunk {tag!r}")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: truncated PNG")


def _unfilter(ftype: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Undo the row filters: ``ftype`` (H,) and filtered bytes (H, W, bpp)
    -> reconstructed bytes (H, W, bpp). The left neighbour of a byte is the
    same byte of the previous pixel, so filters act per byte column."""
    h, w, bpp = filt.shape
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG row filter {int(ftype.max())}")
    if not ftype.any():              # every row unfiltered, as written here
        return filt
    # pixels flattened row-major with one zero row above and one zero
    # column to the left: pixel (y, x) is rec[(y+1)*(w+1) + x+1]
    w1 = w + 1
    rec = np.zeros(((h + 1) * w1, bpp), np.int16)
    f = filt.reshape(h * w, bpp).astype(np.int16)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        k = ys * w1 + (d - ys)       # the up-left neighbour of each pixel
        a, b, c = rec[k + w1], rec[k + 1], rec[k]     # left, up, up-left
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = ftype[ys][:, None]
        if (t != 4).any():           # rows filtered other than by Paeth
            pred = np.select([t == 0, t == 1, t == 2, t == 3],
                             [0, a, b, (a + b) >> 1], pred)
        rec[k + w1 + 1] = (f[ys * w + d - ys] + pred) & 0xFF
    return rec.reshape(h + 1, w1, bpp)[1:, 1:].astype(np.uint8)


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """PNG file contents -> uint8/uint16 array (see the module docstring)."""
    if data[:len(_SIGNATURE)] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for tag, body in _chunks(data, path):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: PNG color type {ctype} (palette) is not "
                         "supported; gray, gray+alpha, RGB and RGBA are")
    if depth not in (8, 16):
        raise ValueError(f"{path}: PNG bit depth {depth}; 8 and 16 are "
                         "supported")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    ch, nb = _CHANNELS[ctype], depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = w * ch * nb + 1
    if raw.size != h * stride:
        raise ValueError(f"{path}: PNG data is {raw.size} bytes, want "
                         f"{h * stride}")
    rows = raw.reshape(h, stride)
    rec = _unfilter(rows[:, 0], rows[:, 1:].reshape(h, w, ch * nb))
    img = rec.reshape(h, w * ch * nb)
    if nb == 2:
        img = img.view(">u2").astype(np.uint16)
    img = img.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def encode_png(img: np.ndarray) -> bytes:
    """uint8/uint16 (H, W) or (H, W, C), C in 1..4 -> PNG file contents, every
    row filter 0 (none)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples are uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"PNG image must be (H, W) or (H, W, 1..4), got "
                         f"{img.shape}")
    h, w, ch = img.shape
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img, img.dtype.newbyteorder(">")
                                if depth == 16 else np.uint8)
    rows = rows.view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[ch], 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def read_ppm(path: str) -> np.ndarray:
    """Binary PPM (P6) -> (H, W, 3) uint8 (uint16 when maxval > 255)."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":           # a comment runs to the EOL
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        if end == pos:
            raise ValueError(f"{path}: truncated PPM header")
        fields.append(data[pos:end])
        pos = end
    if fields[0] != b"P6":
        raise ValueError(f"{path}: not a binary PPM (P6), magic {fields[0]!r}")
    w, h, maxval = (int(x) for x in fields[1:])
    dtype = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
    n = h * w * 3
    pixels = np.frombuffer(data, dtype, count=n, offset=pos + 1)
    return pixels.astype(dtype.newbyteorder("=")).reshape(h, w, 3)


def write_ppm(path: str, img: np.ndarray) -> None:
    """(H, W, 3) uint8 -> binary PPM (P6), the FlyingChairs frame format."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"PPM frames are (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(img).tobytes())
