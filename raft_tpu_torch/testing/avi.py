"""Reader of the MJPG AVI files that ``serving.video`` writes, for the tests
and the card's smoke run (the card's machine has no cv2 to read a video
back)."""

from __future__ import annotations

import struct
from fractions import Fraction
from typing import List, NamedTuple, Tuple


class MjpgAvi(NamedTuple):
    fps: float
    size: Tuple[int, int]          # (width, height)
    frames: List[bytes]            # each '00dc' chunk's JPEG bytes


def _walk(data: bytes, start: int, end: int):
    """(fourcc, body start, body end) of each chunk in ``data[start:end]``."""
    pos = start
    while pos + 8 <= end:
        fourcc = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        if pos + 8 + size > end:
            raise ValueError(f"AVI chunk {fourcc!r} runs past its parent")
        yield fourcc, pos + 8, pos + 8 + size
        pos += 8 + size + size % 2


def read_mjpg_avi(path: str) -> MjpgAvi:
    """Walk the RIFF tree of an MJPG AVI: the stream's rate over scale as
    fps, the main header's width and height, and every ``00dc`` chunk of
    ``movi`` in order."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not a RIFF AVI file")
    (riff_size,) = struct.unpack("<I", data[4:8])
    end = min(len(data), 8 + riff_size)
    fps = size = None
    frames = []
    stack = [(12, end)]
    while stack:
        lo, hi = stack.pop()
        for fourcc, b0, b1 in _walk(data, lo, hi):
            if fourcc == b"LIST":
                stack.append((b0 + 4, b1))
            elif fourcc == b"avih":
                size = struct.unpack("<II", data[b0 + 32:b0 + 40])
            elif fourcc == b"strh" and data[b0:b0 + 4] == b"vids":
                scale, rate = struct.unpack("<II", data[b0 + 20:b0 + 28])
                fps = float(Fraction(rate, scale))
            elif fourcc == b"00dc":
                frames.append((b0, data[b0:b1]))
    if fps is None or size is None:
        raise ValueError(f"{path}: no video stream header")
    return MjpgAvi(fps, size, [f for _, f in sorted(frames)])
