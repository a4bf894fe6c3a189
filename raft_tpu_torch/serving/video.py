"""Multi-flow video visualization, port of ``raft_tpu/serving/video.py`` (the
multi-flow AVI writer of ``raft_trt_utils.py:24-51``).

The JAX package writes the frames with cv2's MJPG ``VideoWriter``; the card's
machine has no cv2, so the port encodes each frame with its own JPEG codec
(``data.jpeg``) and writes the AVI container itself: one RIFF ``AVI `` file
holding ``hdrl`` (``avih``, and a ``strl`` with ``strh`` ``vids``/``MJPG``
and a ``BITMAPINFOHEADER`` ``strf``), ``movi`` with one ``00dc`` chunk per
frame, and an ``idx1`` of keyframe entries. cv2's writer adds OpenDML
headers and so passes 1 GiB; this one raises ``ValueError`` there, as a
RIFF file without them cannot address more. Keeps the fork's fixed
normalization radius so colors stay consistent across frames
(core/utils/flow_viz.py:128-130).
"""

from __future__ import annotations

import struct
from fractions import Fraction
from typing import Optional, Sequence

import numpy as np

from raft_tpu_torch.data.jpeg import encode_jpeg
from raft_tpu_torch.utils.flow_viz import flow_to_image

#: what one RIFF chunk's 32-bit sizes can address, less the headers' room
MAX_AVI_BYTES = 1 << 30

_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10


def _chunk(fourcc: bytes, body: bytes) -> bytes:
    """A RIFF chunk, padded to an even length."""
    return fourcc + struct.pack("<I", len(body)) + body + b"\x00" * (
        len(body) % 2)


def _list(kind: bytes, body: bytes) -> bytes:
    return _chunk(b"LIST", kind + body)


def write_mjpg_avi(path: str, frames: Sequence[bytes], width: int,
                   height: int, fps: float) -> str:
    """Write already-encoded JPEG ``frames`` of ``width`` x ``height`` as an
    MJPG AVI at ``fps`` frames a second."""
    if not frames:
        raise ValueError("an AVI needs at least one frame")
    rate = Fraction(fps).limit_denominator(1001)
    if rate <= 0:
        raise ValueError(f"fps must be positive, got {fps}")
    n = len(frames)
    biggest = max(len(f) for f in frames)
    usec = int(round(1e6 / float(rate)))
    avih = struct.pack("<14I", usec, int(biggest * float(rate)), 0,
                       _AVIF_HASINDEX, n, 0, 1, biggest, width, height,
                       0, 0, 0, 0)
    strh = (b"vids" + b"MJPG" + struct.pack(
        "<IHHIIIIIIII4H", 0, 0, 0, 0, rate.denominator, rate.numerator, 0, n,
        biggest, 0xFFFFFFFF, 0, 0, 0, width, height))
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, b"MJPG",
                       width * height * 3, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + _list(
        b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    # idx1 offsets count from the 'movi' fourcc: the first chunk is at 4
    chunks, index, off = [], [], 4
    for f in frames:
        chunks.append(_chunk(b"00dc", f))
        index.append(b"00dc" + struct.pack("<III", _AVIIF_KEYFRAME, off,
                                           len(f)))
        off += len(chunks[-1])
    movi = _list(b"movi", b"".join(chunks))
    body = b"AVI " + hdrl + movi + _chunk(b"idx1", b"".join(index))
    if len(body) + 8 > MAX_AVI_BYTES:
        raise ValueError(
            f"{path}: {len(body) + 8} bytes is over the 1 GiB a RIFF AVI "
            "without OpenDML headers can hold; write fewer frames per file")
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


def optical_flow_visualize(flows: Sequence[np.ndarray],
                           output: str = "flow.avi",
                           fps: float = 30.0,
                           images: Optional[Sequence[np.ndarray]] = None
                           ) -> str:
    """Render flows (each (H, W, 2)) to an AVI; optionally stack each frame
    above its flow like the reference's side-by-side viz."""
    if len(flows) == 0:
        raise ValueError("no flows to render")
    frames = []
    for i, flow in enumerate(flows):
        flo = flow_to_image(np.asarray(flow))
        if images is not None:
            img = np.asarray(images[i]).astype(np.uint8)
            flo = np.concatenate([img, flo], axis=0)
        frames.append(flo)
    h, w = frames[0].shape[:2]
    if any(f.shape[:2] != (h, w) for f in frames):
        raise ValueError("every frame of a video must have one size")
    return write_mjpg_avi(output, [encode_jpeg(f) for f in frames], w, h, fps)
