"""ctypes binding for the port's native flow-file codec (``flowio.cpp``), the
counterpart of ``raft_tpu/native``.

The library builds with plain ``g++`` at first use into ``build/native/`` at
the repository root, under a name keyed by the source's hash, so an edited
source never loads a stale build. The build compiles to a per-process
temporary name and renames it into place (atomic on POSIX), so concurrent
processes never load a half-written library. Where the build fails, every
function here returns None (or False) and ``data.frame_utils`` reads with
numpy: this is host I/O, not a device kernel. Nothing runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "flowio.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "native")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
#: seconds the first :func:`get_lib` call spent building (0.0 when an
#: up-to-date build was on disk), None before it
build_seconds: Optional[float] = None


def _build() -> Optional[str]:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"_flowio.{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", SRC,
           "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.rename(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when it cannot be built or loaded."""
    global _lib, _tried, build_seconds
    with _lock:
        if _tried:
            return _lib
        _tried = True
        t0 = time.perf_counter()
        so = _build()
        build_seconds = time.perf_counter() - t0
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        i32 = ctypes.c_int32
        p_i32 = ctypes.POINTER(i32)
        p_f32 = ctypes.POINTER(ctypes.c_float)
        lib.flo_header.argtypes = [ctypes.c_char_p, p_i32, p_i32]
        lib.flo_read.argtypes = [ctypes.c_char_p, p_f32, i32, i32]
        lib.flo_write.argtypes = [ctypes.c_char_p, p_f32, i32, i32]
        lib.pfm_header.argtypes = [ctypes.c_char_p, p_i32, p_i32, p_i32,
                                   p_i32, ctypes.POINTER(ctypes.c_int64)]
        lib.pfm_read.argtypes = [ctypes.c_char_p, p_f32, i32, i32, i32, i32,
                                 ctypes.c_int64]
        for fn in (lib.flo_header, lib.flo_read, lib.flo_write,
                   lib.pfm_header, lib.pfm_read):
            fn.restype = i32
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_flo(path: str) -> Optional[np.ndarray]:
    """Native .flo read; None on any failure (the caller falls back)."""
    lib = get_lib()
    if lib is None:
        return None
    w, h = ctypes.c_int32(), ctypes.c_int32()
    if lib.flo_header(os.fsencode(path), ctypes.byref(w),
                      ctypes.byref(h)) != 0:
        return None
    out = np.empty((h.value, w.value, 2), np.float32)
    if lib.flo_read(os.fsencode(path), _f32p(out), w, h) != 0:
        return None
    return out


def write_flo(path: str, uv: np.ndarray) -> bool:
    """Native .flo write of (H, W, 2) flow; False when it did not write."""
    lib = get_lib()
    if lib is None:
        return False
    uv = np.ascontiguousarray(uv, np.float32)
    h, w = uv.shape[:2]
    return lib.flo_write(os.fsencode(path), _f32p(uv), w, h) == 0


def read_pfm(path: str) -> Optional[np.ndarray]:
    """Native PFM read (rows flipped to top-down); None on any failure."""
    lib = get_lib()
    if lib is None:
        return None
    w, h, ch, le = (ctypes.c_int32() for _ in range(4))
    off = ctypes.c_int64()
    if lib.pfm_header(os.fsencode(path), ctypes.byref(w), ctypes.byref(h),
                      ctypes.byref(ch), ctypes.byref(le),
                      ctypes.byref(off)) != 0:
        return None
    shape = ((h.value, w.value, 3) if ch.value == 3
             else (h.value, w.value))
    out = np.empty(shape, np.float32)
    if lib.pfm_read(os.fsencode(path), _f32p(out), w, h, ch, le, off) != 0:
        return None
    return out
