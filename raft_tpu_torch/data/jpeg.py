"""Baseline JPEG codec in numpy: the port's stand-in for PIL's JPEG reader and
for the JPEG frames of cv2's MJPG video writer, which the card's machine does
not have.

:func:`read_jpeg` (and :func:`decode_jpeg` on bytes) decodes a baseline or
extended sequential Huffman JPEG of 8-bit samples (SOF0, SOF1) with one or
three components, sampling factors 1 or 2 on each axis (4:4:4, 4:2:2, 4:2:0,
4:4:0), interleaved or single-component scans, restart intervals (DRI,
RST0-7), byte stuffing, fill bytes and partial MCUs at the right and bottom
edges. It returns what ``np.asarray(PIL.Image.open(path))`` returns: (H, W)
uint8 for one component, (H, W, 3) uint8 RGB for three. Progressive,
lossless, arithmetic-coded, 12-bit and 4-component files, and truncated or
corrupt ones, raise ``ValueError``.

The arithmetic after entropy decoding is libjpeg's, so that the pixels are
libjpeg-turbo's (PIL's decoder) bit for bit: the integer "islow" inverse DCT
(jidctint.c) with its wrapping range limit, the "fancy" triangle upsampling
(jdsample.c: h2v1, h2v2, h1v2) and the fixed-point YCbCr->RGB tables
(jdcolor.c). Huffman decoding is the one sequential part; it runs in Python
over a table indexed by the next 16 bits of the stream that gives a code's
length, its run and its value in one step. Dequantisation, the inverse DCT,
upsampling and colour conversion run vectorized over all blocks at once.

:func:`write_jpeg` (and :func:`encode_jpeg` to bytes) writes a baseline JFIF
file: 4:2:0 or 4:4:4, the Annex K quantisation tables scaled by libjpeg's
quality formula and the Annex K Huffman tables, a float forward DCT
vectorized over blocks, and vectorized bit packing.
"""

from __future__ import annotations

import array
import functools
import itertools
import struct

import numpy as np

# zigzag position k -> natural (row-major) index in the 8x8 block
NATURAL = sorted(range(64), key=lambda n: (
    n // 8 + n % 8, n // 8 if (n // 8 + n % 8) % 2 else -(n // 8)))

# modes that are not baseline sequential Huffman, by SOF marker
_UNSUPPORTED_SOF = {
    0xC2: "progressive (SOF2)", 0xC3: "lossless (SOF3)",
    0xC5: "differential sequential (SOF5)",
    0xC6: "differential progressive (SOF6)",
    0xC7: "differential lossless (SOF7)",
    0xC9: "arithmetic-coded sequential (SOF9)",
    0xCA: "arithmetic-coded progressive (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded differential sequential (SOF13)",
    0xCE: "arithmetic-coded differential progressive (SOF14)",
    0xCF: "arithmetic-coded differential lossless (SOF15)",
}


# ---------------------------------------------------------------- decoding

@functools.lru_cache(maxsize=32)
def _huffman_lut(counts: bytes, symbols: bytes, ac: bool):
    """Entries for every 16-bit window of the stream: ``(advance, run,
    value, size)``. ``advance`` covers the code and, where they fit in the
    window, its ``size`` extra bits, whose sign-extended ``value`` is then
    given; otherwise ``value`` is None and the caller reads the extra bits.
    ``run`` is the zero run before an AC coefficient (63 for end of block).
    Windows that start no code map to None. Cached: the standard tables
    recur in every frame of a video; callers never mutate the list."""
    if len(symbols) != sum(counts):
        raise ValueError("malformed Huffman table")
    length = np.zeros(65536, np.int64)
    symbol = np.zeros(65536, np.int64)
    code = k = 0
    for n in range(1, 17):
        for _ in range(counts[n - 1]):
            if code >= 1 << n:
                raise ValueError("malformed Huffman table")
            lo = code << (16 - n)
            length[lo:lo + (1 << (16 - n))] = n
            symbol[lo:lo + (1 << (16 - n))] = symbols[k]
            code += 1
            k += 1
        code <<= 1
    if ac:
        run, size = symbol >> 4, symbol & 15
        run = np.where((size == 0) & (run != 15), 63, run)  # EOB, or ZRL
    else:
        run, size = np.zeros_like(symbol), symbol
    fits = length + size <= 16
    bits = (np.arange(65536) >> np.maximum(16 - length - size, 0)) & (
        (1 << size) - 1)
    val = np.where((size == 0) | (bits >> np.maximum(size - 1, 0) > 0), bits,
                   bits - (1 << size) + 1).astype(object)
    val[~fits] = None
    lut = list(zip(np.where(fits, length + size, length).tolist(),
                   run.tolist(), val.tolist(), size.tolist()))
    for w in np.flatnonzero(length == 0).tolist():
        lut[w] = None
    return lut


def _windows(segment: bytes) -> array.array:
    """The 16 bits of ``segment`` that start at each bit position (zeros past
    its end), as an unsigned 16-bit array indexed by bit position."""
    b = np.frombuffer(segment + bytes(6), np.uint8).astype(np.uint32)
    v = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    w = (v[:, None] >> (8 - np.arange(8, dtype=np.uint32))) & 0xFFFF
    return array.array("H", w.astype(np.uint16).tobytes())


def _split_scan(data: bytes, pos: int, name: str):
    """The entropy-coded data from ``pos``: its restart intervals with the
    stuffing removed, and the position of the marker that ends it."""
    intervals, parts = [], []
    start = i = pos
    n = len(data)
    while True:
        j = data.find(b"\xff", i)
        if j < 0 or j + 1 >= n:
            raise ValueError(f"{name}: truncated JPEG (scan runs to the end "
                             "of the file)")
        if data[j + 1] == 0x00:             # stuffed 0xFF data byte
            parts.append(data[start:j + 1])
            start = i = j + 2
            continue
        parts.append(data[start:j])
        k = j
        while k < n and data[k] == 0xFF:    # fill bytes before a marker
            k += 1
        if k >= n:
            raise ValueError(f"{name}: truncated JPEG")
        if 0xD0 <= data[k] <= 0xD7:         # RSTn: next interval
            intervals.append(b"".join(parts))
            parts = []
            start = i = k + 1
            continue
        if data[k] == 0x00:                 # fill bytes, then a stuffed FF
            parts.append(b"\xff")
            start = i = k + 1
            continue
        intervals.append(b"".join(parts))
        return intervals, j


def _decode_interval(win, pos, end, offsets, pattern, coefs, natural, name):
    """Entropy-decode the blocks at ``offsets`` (in stream order, starting at
    an MCU) from bit ``pos`` of ``win`` into ``coefs``; ``pattern`` gives
    each block of an MCU its ``(dc_lut, ac_lut, predictor)``. Returns the
    bit position after them. The DC predictors start at 0, as they do after
    every restart marker."""
    pred = [0, 0, 0, 0]
    try:
        for base, (dct, act, ci) in zip(offsets, itertools.cycle(pattern)):
            adv, _, val, s = dct[win[pos]]
            pos += adv
            if val is None:
                t = win[pos] >> (16 - s)
                pos += s
                val = t if t >> (s - 1) else t - (1 << s) + 1
            val += pred[ci]
            pred[ci] = val
            coefs[base] = val
            k = 1
            while k < 64:
                adv, run, val, s = act[win[pos]]
                pos += adv
                if val is None:
                    t = win[pos] >> (16 - s)
                    pos += s
                    val = t if t >> (s - 1) else t - (1 << s) + 1
                k += run
                if val:
                    coefs[base + natural[k]] = val
                k += 1
    except (TypeError, IndexError, OverflowError):  # no such code, or a
        # coefficient past the block or out of range
        raise ValueError(f"{name}: corrupt JPEG entropy-coded data") from None
    if pos > end:
        raise ValueError(f"{name}: truncated JPEG (entropy-coded data ends "
                         "inside a block)")
    return pos


def _range_limit_table() -> np.ndarray:
    """jdmaster.c's post-IDCT table: a sample plus 128, clamped, indexed by
    the descaled value masked to 10 bits (so values past +-512 wrap)."""
    idx = np.arange(1024)
    signed = np.where(idx < 512, idx, idx - 1024)
    return np.clip(signed + 128, 0, 255).astype(np.uint8)


_RANGE_LIMIT = _range_limit_table()


def _idct_pass(x, shift):
    """jidctint.c's 1-D islow IDCT along axis 1 of (N, 8, M) int64 values,
    descaled by ``shift`` bits with rounding."""
    x0, x1, x2, x3, x4, x5, x6, x7 = (x[:, i] for i in range(8))
    z1 = (x2 + x6) * 4433
    tmp2 = z1 + x6 * -15137
    tmp3 = z1 + x2 * 6270
    tmp0 = (x0 + x4) << 13
    tmp1 = (x0 - x4) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    z1, z2, z3, z4 = x7 + x1, x5 + x3, x7 + x3, x5 + x1
    z5 = (z3 + z4) * 9633
    t0, t1, t2, t3 = x7 * 2446, x5 * 16819, x3 * 25172, x1 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    out = np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                    tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3], axis=1)
    return (out + (1 << (shift - 1))) >> shift


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """(N, 8, 8) dequantized coefficients (int64, natural order) -> (N, 8, 8)
    uint8 samples, as libjpeg's ``jpeg_idct_islow``: columns first with two
    extra bits of precision kept, then rows."""
    ws = _idct_pass(coef, 13 - 2)
    rows = _idct_pass(ws.transpose(0, 2, 1), 13 + 2 + 3).transpose(0, 2, 1)
    return _RANGE_LIMIT[rows & 1023]


def _fancy_h2(x: np.ndarray) -> np.ndarray:
    """jdsample.c's h2v1 triangle filter along the last axis of int32 rows:
    3/4 of the nearer sample and 1/4 of the further, edges replicated."""
    p = np.concatenate([x[:, :1], x, x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + p[:, :-2] + 1) >> 2
    out[:, 1::2] = (3 * x + p[:, 2:] + 2) >> 2
    return out


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """Upsample a component plane of its own (downsampled) size by ``fh``
    across and ``fv`` down, each 1 or 2, as libjpeg-turbo does with fancy
    upsampling on (its default, and PIL's)."""
    x = plane.astype(np.int32)
    if fv == 1 and fh == 1:
        return x
    if fv == 1:                                        # h2v1
        if x.shape[1] > 2:
            return _fancy_h2(x)
        return np.repeat(x, 2, axis=1)
    up = np.concatenate([x[:1], x[:-1]], axis=0)       # row above (edge: self)
    dn = np.concatenate([x[1:], x[-1:]], axis=0)       # row below
    if fh == 1:                                        # h1v2
        out = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
        out[0::2] = (3 * x + up + 1) >> 2
        out[1::2] = (3 * x + dn + 2) >> 2
        return out
    if x.shape[1] <= 2:                                # h2v2, too narrow
        return np.repeat(np.repeat(x, 2, axis=0), 2, axis=1)
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int32)
    for r, near in ((0, up), (1, dn)):                 # h2v2
        cs = 3 * x + near
        p = np.concatenate([cs[:, :1], cs, cs[:, -1:]], axis=1)
        out[r::2, 0::2] = (3 * cs + p[:, :-2] + 8) >> 4
        out[r::2, 1::2] = (3 * cs + p[:, 2:] + 7) >> 4
    return out


def _ycc_tables():
    """jdcolor.c's build_ycc_rgb_table: 16-bit fixed point, Cb->G and Cr->G
    kept scaled (with the rounding half folded into Cb->G)."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode a JPEG held in ``data``; see the module docstring. ``name``
    only labels errors."""
    try:
        return _decode(bytes(data), name)
    except (IndexError, struct.error):      # a segment shorter than its fields
        raise ValueError(f"{name}: malformed JPEG segment") from None


def _decode(data: bytes, name: str) -> np.ndarray:
    n = len(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
    pos = 2
    qt, huff = {}, {}
    frame = None
    restart = 0
    jfif = False
    adobe = None
    coefs = None
    scanned = set()
    while True:
        if pos >= n:
            raise ValueError(f"{name}: truncated JPEG (no EOI marker)")
        if data[pos] != 0xFF:
            raise ValueError(f"{name}: corrupt JPEG (expected a marker at "
                             f"byte {pos})")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise ValueError(f"{name}: truncated JPEG (no EOI marker)")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:                                  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:        # no length
            continue
        if pos + 2 > n:
            raise ValueError(f"{name}: truncated JPEG")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        if length < 2 or pos + length > n:
            raise ValueError(f"{name}: truncated JPEG (marker 0xFF"
                             f"{marker:02X} runs past the end)")
        seg = data[pos + 2:pos + length]
        pos += length
        if marker == 0xDB:                                  # DQT
            j = 0
            while j < len(seg):
                pq, tq = seg[j] >> 4, seg[j] & 15
                size = 128 if pq else 64
                vals = np.frombuffer(seg[j + 1:j + 1 + size],
                                     ">u2" if pq else np.uint8)
                if vals.size != 64:
                    raise ValueError(f"{name}: malformed DQT segment")
                table = np.zeros(64, np.int64)
                table[NATURAL] = vals
                qt[tq] = table
                j += 1 + size
        elif marker == 0xC4:                                # DHT
            j = 0
            while j + 17 <= len(seg):
                tc, th = seg[j] >> 4, seg[j] & 15
                counts = seg[j + 1:j + 17]
                total = sum(counts)
                try:
                    huff[(tc, th)] = _huffman_lut(
                        counts, seg[j + 17:j + 17 + total], tc == 1)
                except ValueError as e:
                    raise ValueError(f"{name}: {e}") from None
                j += 17 + total
        elif marker in (0xC0, 0xC1):                        # SOF0, SOF1
            if frame is not None:
                raise ValueError(f"{name}: more than one frame header")
            if len(seg) < 6:
                raise ValueError(f"{name}: malformed SOF segment")
            prec, hgt, wid, nc = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise ValueError(f"{name}: {prec}-bit JPEG samples are not "
                                 "supported (8-bit only)")
            if nc not in (1, 3):
                raise ValueError(f"{name}: {nc}-component JPEG is not "
                                 "supported (1 or 3 components)")
            if hgt == 0 or wid == 0 or len(seg) < 6 + 3 * nc:
                raise ValueError(f"{name}: malformed SOF segment")
            comps = []
            for c in range(nc):
                cid, hv, tq = seg[6 + 3 * c:9 + 3 * c]
                comps.append((cid, hv >> 4, hv & 15, tq))
            if any(h not in (1, 2) or v not in (1, 2)
                   for _, h, v, _ in comps):
                raise ValueError(f"{name}: sampling factors other than 1 "
                                 "and 2 are not supported")
            frame = _Frame(wid, hgt, comps)
            coefs = array.array("i", bytes(4 * 64 * frame.total_blocks))
        elif marker in _UNSUPPORTED_SOF:
            raise ValueError(f"{name}: {_UNSUPPORTED_SOF[marker]} JPEG is not "
                             "supported (baseline sequential Huffman only)")
        elif marker == 0xCC:
            raise ValueError(f"{name}: arithmetic-coded JPEG is not "
                             "supported (baseline sequential Huffman only)")
        elif marker == 0xDD:                                # DRI
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDA:                                # SOS
            if frame is None:
                raise ValueError(f"{name}: scan before the frame header")
            ns = seg[0]
            sel = [(seg[1 + 2 * i], seg[2 + 2 * i]) for i in range(ns)]
            if seg[1 + 2 * ns:4 + 2 * ns] != b"\x00\x3f\x00":
                raise ValueError(f"{name}: not a sequential scan")
            intervals, pos = _split_scan(data, pos, name)
            offsets, pattern = frame.scan_blocks(sel, huff, name)
            scanned.update(cid for cid, _ in sel)
            _decode_scan(intervals, offsets, pattern, restart, coefs, name)
        # APPn, COM and other segments carry nothing the pixels need
    if frame is None or len(scanned) < len(frame.comps):
        raise ValueError(f"{name}: JPEG has no image data for every "
                         "component")
    return frame.pixels(coefs, qt, jfif, adobe, name)


def _decode_scan(intervals, offsets, pattern, restart, coefs, name):
    step = (restart * len(pattern)) if restart else len(offsets)
    chunks = range(0, len(offsets), step)
    if len(intervals) < len(chunks):
        raise ValueError(f"{name}: truncated JPEG (restart intervals "
                         "missing)")
    for seg, b0 in zip(intervals, chunks):
        _decode_interval(_windows(seg), 0, 8 * len(seg),
                         offsets[b0:b0 + step], pattern, coefs, NATURAL, name)


class _Frame:
    """The frame header's geometry: component planes, their block grids and
    where each block's 64 coefficients sit in the flat coefficient list."""

    def __init__(self, width, height, comps):
        self.width, self.height, self.comps = width, height, comps
        self.hmax = max(h for _, h, _, _ in comps)
        self.vmax = max(v for _, _, v, _ in comps)
        self.mcux = -(-width // (8 * self.hmax))
        self.mcuy = -(-height // (8 * self.vmax))
        self.offset, off = [], 0
        for _, h, v, _ in comps:
            self.offset.append(off)
            off += self.mcuy * v * self.mcux * h
        self.total_blocks = off

    def grid(self, c):
        """(rows, cols) of component ``c``'s block grid, padded to whole
        MCUs, and its own sample size (downsampled height, width)."""
        _, h, v, _ = self.comps[c]
        return ((self.mcuy * v, self.mcux * h),
                (-(-self.height * v // self.vmax),
                 -(-self.width * h // self.hmax)))

    def scan_blocks(self, sel, huff, name):
        """The scan's block offsets into the coefficient array, in stream
        order, and each block of an MCU's ``(dc_lut, ac_lut, predictor)``."""
        ids = [cid for cid, _, _, _ in self.comps]
        entries = []
        for slot, (cid, tables) in enumerate(sel):
            if cid not in ids:
                raise ValueError(f"{name}: scan names unknown component "
                                 f"{cid}")
            if (0, tables >> 4) not in huff or (1, tables & 15) not in huff:
                raise ValueError(f"{name}: scan uses an undefined Huffman "
                                 "table")
            entries.append((ids.index(cid), huff[(0, tables >> 4)],
                            huff[(1, tables & 15)], slot))
        if len(entries) == 1:               # non-interleaved: the plane's own
            c, dct, act, slot = entries[0]  # blocks, in raster order
            (_, cols), (ch, cw) = self.grid(c)
            by, bx = np.mgrid[0:-(-ch // 8), 0:-(-cw // 8)]
            offs = (self.offset[c] + by * cols + bx).ravel() * 64
            return offs.tolist(), [(dct, act, slot)]
        per_mcu, pattern = [], []
        for c, dct, act, slot in entries:
            _, h, v, _ = self.comps[c]
            (_, cols), _ = self.grid(c)
            my, mx, j, i = np.meshgrid(np.arange(self.mcuy),
                                       np.arange(self.mcux), np.arange(v),
                                       np.arange(h), indexing="ij")
            offs = (self.offset[c] + (my * v + j) * cols + mx * h + i) * 64
            per_mcu.append(offs.reshape(self.mcuy * self.mcux, v * h))
            pattern += [(dct, act, slot)] * (v * h)
        return np.concatenate(per_mcu, axis=1).ravel().tolist(), pattern

    def pixels(self, coefs, qt, jfif, adobe, name):
        flat = np.frombuffer(coefs, np.int32).astype(np.int64).reshape(-1, 64)
        planes = []
        for c, (_, h, v, tq) in enumerate(self.comps):
            if tq not in qt:
                raise ValueError(f"{name}: undefined quantisation table {tq}")
            (rows, cols), (ch, cw) = self.grid(c)
            blk = flat[self.offset[c]:self.offset[c] + rows * cols] * qt[tq]
            smp = _idct_islow(blk.reshape(-1, 8, 8))
            plane = smp.reshape(rows, cols, 8, 8).transpose(0, 2, 1, 3)
            plane = plane.reshape(rows * 8, cols * 8)[:ch, :cw]
            up = _upsample(plane, self.hmax // h, self.vmax // v)
            planes.append(up[:self.height, :self.width])
        if len(planes) == 1:
            return planes[0].astype(np.uint8)
        ids = tuple(cid for cid, _, _, _ in self.comps)
        # jdapimin.c default_decompress_parms: which 3-component files are RGB
        if jfif:
            rgb = False
        elif adobe is not None:
            rgb = adobe == 0
        else:
            rgb = ids == (82, 71, 66)                         # 'R', 'G', 'B'
        if rgb:
            return np.stack(planes, axis=-1).astype(np.uint8)
        return _ycc_to_rgb(*(p.astype(np.int64) for p in planes))


def read_jpeg(path: str) -> np.ndarray:
    """Decode the JPEG file at ``path``; see :func:`decode_jpeg`."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)


# ---------------------------------------------------------------- encoding

# ITU-T T.81 Annex K: tables K.1 and K.2 (natural order) and K.3-K.6
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.full(64, 99)
_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], bytes(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              bytes(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119],
              bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))

DEFAULT_QUALITY = 90


def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling and jpeg_add_quant_table (baseline:
    entries clamped to 1..255)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _code_table(spec):
    """Annex C: symbol -> (code, length) arrays of 256 entries."""
    counts, symbols = spec
    codes = np.zeros(256, np.int64)
    lengths = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]], lengths[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return codes, lengths


def _dct_matrix() -> np.ndarray:
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    a = np.sqrt(2 / 8) * np.cos((2 * x + 1) * u * np.pi / 16)
    a[0] /= np.sqrt(2)
    return a


_DCT = _dct_matrix()


def _blocks(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """A plane padded by edge replication to (rows*8, cols*8), as (rows,
    cols, 8, 8) blocks."""
    ph, pw = rows * 8 - plane.shape[0], cols * 8 - plane.shape[1]
    p = np.pad(plane, ((0, ph), (0, pw)), mode="edge")
    return p.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3)


def _magnitude(v: np.ndarray):
    """(size category, the category's extra bits) of coefficients ``v``:
    negative values are sent as v - 1 in ``size`` bits (F.1.2.1)."""
    a = np.abs(v)
    size = np.zeros(v.shape, np.int64)
    nz = a > 0
    size[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    bits = np.where(v < 0, v + (1 << size) - 1, v)
    return size, bits


def _entropy_code(zz: np.ndarray, tables: np.ndarray, comp: np.ndarray,
                  n_comp: int, specs) -> bytes:
    """Huffman-code quantized blocks ``zz`` (N, 64) int64 in zigzag order and
    stream order; ``tables[i]`` picks block i's (DC, AC) code tables,
    ``comp[i]`` its component (for the DC predictor). Returns the stuffed
    entropy-coded bytes."""
    n = zz.shape[0]
    dc = zz[:, 0]
    prev = np.zeros(n, np.int64)
    for c in range(n_comp):
        idx = np.flatnonzero(comp == c)
        prev[idx[1:]] = dc[idx[:-1]]
    codes = [_code_table(s) for s in specs]     # dc0, ac0, dc1, ac1
    dc_code = np.stack([codes[0][0], codes[2][0]])
    dc_len = np.stack([codes[0][1], codes[2][1]])
    ac_code = np.stack([codes[1][0], codes[3][0]])
    ac_len = np.stack([codes[1][1], codes[3][1]])

    # DC items: category code then its bits
    size, bits = _magnitude(dc - prev)
    keys = [np.arange(n) * 130]
    vals = [(dc_code[tables, size] << size) | bits]
    lens = [dc_len[tables, size] + size]
    # AC items: ZRLs for runs over 15, then run/size code and bits
    blk, k = np.nonzero(zz[:, 1:])
    k = k + 1
    prevk = np.zeros_like(k)            # the block's previous nonzero, or 0
    same = blk[1:] == blk[:-1]
    prevk[1:][same] = k[:-1][same]
    run = k - prevk - 1
    v = zz[blk, k]
    size, bits = _magnitude(v)
    tb = tables[blk]
    sym = (run % 16) * 16 + size
    keys.append(blk * 130 + 2 * k)
    vals.append((ac_code[tb, sym] << size) | bits)
    lens.append(ac_len[tb, sym] + size)
    nzrl = run // 16
    zrl = np.repeat(np.arange(len(k)), nzrl)
    keys.append(blk[zrl] * 130 + 2 * k[zrl] - 1)
    vals.append(ac_code[tb[zrl], 0xF0])
    lens.append(ac_len[tb[zrl], 0xF0])
    # EOB where the block's last nonzero coefficient is before 63
    last = np.zeros(n, np.int64)
    last[blk] = k                        # nonzero order: the last write wins
    eob = np.flatnonzero(last < 63)
    keys.append(eob * 130 + 129)
    vals.append(ac_code[tables[eob], 0x00])
    lens.append(ac_len[tables[eob], 0x00])

    order = np.argsort(np.concatenate(keys), kind="stable")
    val = np.concatenate(vals)[order]
    ln = np.concatenate(lens)[order]
    ends = np.cumsum(ln)
    total = int(ends[-1])
    item = np.repeat(np.arange(len(ln)), ln)
    pos = np.arange(total) - (ends - ln)[item]
    bit = (val[item] >> (ln[item] - 1 - pos)) & 1
    bit = np.concatenate([bit, np.ones(-total % 8, np.int64)])  # 1-bit pad
    out = np.packbits(bit.astype(np.uint8))
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode_jpeg(image: np.ndarray, quality: int = DEFAULT_QUALITY,
                subsampling: str = "4:2:0") -> bytes:
    """Encode an (H, W) gray or (H, W, 3) RGB uint8 image as a baseline JFIF
    JPEG (``subsampling`` "4:2:0" or "4:4:4" for RGB)."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"expected (H, W) or (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    if subsampling not in ("4:2:0", "4:4:4"):
        raise ValueError(f"subsampling must be 4:2:0 or 4:4:4, got "
                         f"{subsampling!r}")
    hgt, wid = img.shape[:2]
    if not (0 < hgt < 65536 and 0 < wid < 65536):
        raise ValueError(f"JPEG size out of range: {wid}x{hgt}")
    f = img.astype(np.float64)
    if img.ndim == 2:
        planes, factors = [f], [(1, 1)]
    else:
        r, g, b = f[..., 0], f[..., 1], f[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128
        cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128
        planes = [y, cb, cr]
        s = 2 if subsampling == "4:2:0" else 1
        factors = [(s, s), (1, 1), (1, 1)]
    hmax = factors[0][0]
    mcux, mcuy = -(-wid // (8 * hmax)), -(-hgt // (8 * hmax))
    qtabs = [_quant_table(_LUMA_Q, quality), _quant_table(_CHROMA_Q, quality)]
    grids = []
    for c, (plane, (h, _)) in enumerate(zip(planes, factors)):
        if h < hmax:                     # 2x2 box average of the padded plane
            pad = np.pad(plane, ((0, (-plane.shape[0]) % 2),
                                 (0, (-plane.shape[1]) % 2)), mode="edge")
            plane = pad.reshape(pad.shape[0] // 2, 2, pad.shape[1] // 2,
                                2).mean(axis=(1, 3))
        blk = _blocks(plane - 128.0, mcuy * h, mcux * h)
        coef = _DCT @ blk @ _DCT.T
        q = qtabs[min(c, 1)].reshape(8, 8)
        quant = np.sign(coef) * np.floor(np.abs(coef) / q + 0.5)
        zz = quant.reshape(mcuy * h, mcux * h, 64)[..., NATURAL]
        # MCU order: each MCU's h x h blocks of this component
        zz = zz.reshape(mcuy, h, mcux, h, 64).transpose(0, 2, 1, 3, 4)
        grids.append(zz.reshape(mcuy * mcux, h * h, 64).astype(np.int64))
    stream = np.concatenate(grids, axis=1).reshape(-1, 64)
    per_mcu = [h * h for h, _ in factors]
    comp = np.tile(np.repeat(np.arange(len(planes)), per_mcu), mcux * mcuy)
    tables = np.minimum(comp, 1)
    specs = [_DC_LUMA, _AC_LUMA, _DC_CHROMA, _AC_CHROMA]
    scan = _entropy_code(stream, tables, comp, len(planes), specs)

    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00\x01\x01\x00" + struct.pack(">HH", 1, 1)
                    + b"\x00\x00")]
    n_tab = min(len(planes), 2)          # table 0 luma, 1 chroma
    for t, q in enumerate(qtabs[:n_tab]):
        out.append(_segment(0xDB, bytes([t]) + q[NATURAL].astype(
            np.uint8).tobytes()))
    sof = struct.pack(">BHHB", 8, hgt, wid, len(planes))
    for c, (h, v) in enumerate(factors):
        sof += bytes([c + 1, (h << 4) | v, min(c, 1)])
    out.append(_segment(0xC0, sof))
    for t in range(n_tab):
        for cls in (0, 1):
            counts, syms = specs[2 * t + cls]
            out.append(_segment(0xC4, bytes([(cls << 4) | t] + counts) + syms))
    sos = bytes([len(planes)])
    for c in range(len(planes)):
        sos += bytes([c + 1, (min(c, 1) << 4) | min(c, 1)])
    out.append(_segment(0xDA, sos + b"\x00\x3f\x00"))
    out += [scan, b"\xff\xd9"]
    return b"".join(out)


def write_jpeg(path: str, image: np.ndarray, quality: int = DEFAULT_QUALITY,
               subsampling: str = "4:2:0") -> None:
    """Write ``image`` as a baseline JFIF JPEG; see :func:`encode_jpeg`."""
    data = encode_jpeg(image, quality, subsampling)
    with open(path, "wb") as f:
        f.write(data)
