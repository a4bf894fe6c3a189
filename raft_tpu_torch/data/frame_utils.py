"""Flow-file I/O, port of ``raft_tpu/data/frame_utils.py`` with numpy and the
port's own PNG and JPEG codecs (``data.png``, ``data.jpeg``) in place of PIL
and cv2.

``.flo`` and ``.pfm`` go through the native codec (``raft_tpu_torch.native``,
built with g++ at first use) first, as in the JAX package, and through the
numpy readers (``read_flow_numpy``, ``write_flow_numpy``, ``read_pfm_numpy``)
where it cannot be built or fails on a file.

- ``.flo``: float32 tag 202021.25, int32 w/h, interleaved (u, v) rows
  (frame_utils.py:10-31,70-99).
- ``.pfm``: PF/Pf header, scale sign = endianness, rows bottom-up
  (frame_utils.py:33-68).
- KITTI 16-bit PNG: channels (u, v, valid) in the file's R, G, B order,
  flow = (px - 2^15)/64 (frame_utils.py:102-120). cv2 reads them as BGR and
  the JAX package flips them back; the port reads the file order directly.
"""

from __future__ import annotations

import re
from os.path import splitext

import numpy as np

from raft_tpu_torch import native
from raft_tpu_torch.data.jpeg import read_jpeg
from raft_tpu_torch.data.png import read_png, read_ppm, write_png

TAG_FLO = 202021.25


def read_flow(path: str) -> np.ndarray:
    """Read a Middlebury .flo file -> (H, W, 2) float32."""
    out = native.read_flo(path)       # GIL-free when built
    return read_flow_numpy(path) if out is None else out


def read_flow_numpy(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != np.float32(TAG_FLO):
            raise ValueError(f"{path}: invalid .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flow(path: str, uv: np.ndarray) -> None:
    """Write (H, W, 2) float32 flow as .flo."""
    uv = np.asarray(uv, np.float32)
    if uv.ndim != 3 or uv.shape[2] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {uv.shape}")
    if not native.write_flo(path, uv):
        write_flow_numpy(path, uv)


def write_flow_numpy(path: str, uv: np.ndarray) -> None:
    uv = np.asarray(uv, np.float32)
    h, w = uv.shape[:2]
    with open(path, "wb") as f:
        np.array([TAG_FLO], np.float32).tofile(f)
        np.array([w], np.int32).tofile(f)
        np.array([h], np.int32).tofile(f)
        uv.tofile(f)


def read_pfm(path: str) -> np.ndarray:
    out = native.read_pfm(path)
    return read_pfm_numpy(path) if out is None else out


def read_pfm_numpy(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file")

        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError(f"{path}: malformed PFM header")
        width, height = map(int, dims.groups())

        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")

    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)).copy()


def write_pfm(path: str, data: np.ndarray, scale: float = 1.0) -> None:
    data = np.asarray(data, np.float32)
    color = data.ndim == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(f"{-scale}\n".encode())  # little-endian
        np.flipud(data).astype("<f").tofile(f)


def read_flow_kitti(path: str):
    """KITTI flow png -> ((H, W, 2) float32 flow, (H, W) float32 valid)."""
    img = read_png(path).astype(np.float32)   # (u, v, valid), file order
    flow, valid = img[:, :, :2], img[:, :, 2]
    flow = (flow - 2 ** 15) / 64.0
    return flow, valid


def write_flow_kitti(path: str, uv: np.ndarray) -> None:
    uv = 64.0 * np.asarray(uv) + 2 ** 15
    valid = np.ones([uv.shape[0], uv.shape[1], 1])
    write_png(path, np.concatenate([uv, valid], axis=-1).astype(np.uint16))


def read_disp_kitti(path: str):
    disp = read_png(path) / 256.0
    valid = disp > 0.0
    flow = np.stack([-disp, np.zeros_like(disp)], -1)
    return flow, valid


def read_gen(path: str):
    """Extension-dispatched reader (frame_utils.py:123-137). Images come back
    as numpy arrays (uint8 for 8-bit files), where the JAX package returns a
    PIL ``Image``."""
    ext = splitext(path)[-1].lower()
    if ext == ".png":
        return read_png(path)
    if ext == ".ppm":
        return read_ppm(path)
    if ext in (".jpeg", ".jpg"):
        return read_jpeg(path)
    if ext in (".bin", ".raw"):
        return np.load(path)
    if ext == ".flo":
        return read_flow(path).astype(np.float32)
    if ext == ".pfm":
        flow = read_pfm(path).astype(np.float32)
        return flow if flow.ndim == 2 else flow[:, :, :-1]
    return []
