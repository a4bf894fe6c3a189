"""Build ``raft_tpu_torch/csrc/*.cu`` into one shared library at first use.

Route: ``nvcc`` by hand into a library with a plain C interface, loaded with
``ctypes`` (seconds to build, against minutes for a source that includes
PyTorch's headers). Each source compiles in its own ``nvcc`` process, all
started together, then one link. The library lands in ``build/kernels/`` at
the repository root (listed in ``.gitignore``) under a name keyed by the
hash of the sources and of the headers they include (``csrc/*.cuh``), so an
edited source never loads a stale build.

Nothing here runs at import: :func:`library` builds and loads on its first
call, which only a wrapper given a CUDA tensor makes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# argtypes of every exported function: pointers and the stream as c_void_p
# (ctypes would otherwise pass them as 32-bit ints and cut them)
SIGNATURES = {
    "corr_lookup_launch": [_P, _P, _P, _I, _P, _P, _LL, _I, _I, _P],
    "gru_gates_launch": [_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _P],
    "gru_blend_launch": [_P, _P, _P, _P, _P, _LL, _LL, _I, _I, _P],
    "corr_scatter_launch": [_P, _P, _P, _I, _P, _P, _LL, _I, _I, _P],
    "gru_gates_bwd_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL,
                             _I, _I, _P],
    "gru_blend_bwd_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _I,
                             _I, _P],
    "corr_alt_launch": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                        _P, _P],
    "gma_attention_launch": [_P, _P, _P, _I, _I, _F, _P, _P],
    "gma_aggregate_launch": [_P, _P, _P, _P, _P, _I, _I, _P, _P],
    "gma_aggregate_occupancy": [ctypes.POINTER(_I), ctypes.POINTER(_LL)],
}


def dtype_code(dtype) -> int:
    """The ``dtype`` argument of the launch functions: 0 float32, 1 bfloat16
    (the ``dtype ==`` switches in ``csrc/*.cu``); raises for others."""
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise ValueError(f"dtype {dtype}: the kernels take float32 or "
                         "bfloat16")
    return codes[dtype]


@dataclasses.dataclass
class Build:
    """A loaded kernel library and how it was made."""

    lib: ctypes.CDLL
    path: str
    seconds: float  # 0.0 when an up-to-date build was found on disk
    log: str        # nvcc's output, -Xptxas -v register/smem use included
                    # (kept beside the library, read back with a found build)


_lock = threading.Lock()
_build: Build | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME: the CUDA kernels of "
        "raft_tpu_torch are built from source at first use")


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest(srcs) -> str:
    """The build's key: the flags, the sources and the headers they
    include (``csrc/*.cuh``)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands concurrently; raise with their output if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "\n".join(o for o in outs if o)
    bad = [c for c, p in zip(cmds, procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"nvcc failed: {' '.join(bad[0])}\n{log}")
    return log


def _compile(srcs, lib_path: str) -> str:
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, os.path.basename(s) + f".{tag}.o")
            for s in srcs]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", s, "-o", o]
                    for s, o in zip(srcs, objs)])
    tmp = f"{lib_path}.{tag}.tmp"
    log += _run_all([[nvcc, "-shared", *NVCC_FLAGS[:1], "-o", tmp, *objs]])
    with open(f"{tmp}.log", "w") as f:
        f.write(log)
    os.replace(f"{tmp}.log", f"{lib_path}.log")
    os.replace(tmp, lib_path)
    for o in objs:
        os.unlink(o)
    return log


def library() -> Build:
    """Build (once per process, and only if no current build is on disk) and
    load the kernel library."""
    global _build
    with _lock:
        if _build is not None:
            return _build
        srcs = _sources()
        path = os.path.join(BUILD_DIR, f"libraft_kernels_{_digest(srcs)}.so")
        seconds = 0.0
        log = "found an up-to-date build; nothing compiled"
        if os.path.exists(f"{path}.log"):
            with open(f"{path}.log") as f:
                log = f"{log}; its log:\n{f.read()}"
        if not os.path.exists(path):
            t0 = time.perf_counter()
            log = _compile(srcs, path)
            seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.corr_alt_smem_bytes.argtypes = [_I]
        lib.corr_alt_smem_bytes.restype = _LL
        lib.raft_kernels_error_string.argtypes = [ctypes.c_int]
        lib.raft_kernels_error_string.restype = ctypes.c_char_p
        _build = Build(lib, path, seconds, log)
        return _build


def stream(t) -> int:
    """The current CUDA stream of ``t``'s device, which must be the current
    device: the kernels launch on PyTorch's current stream, and the library
    launches on the current device."""
    import torch

    if t.device.index != torch.cuda.current_device():
        raise ValueError(
            f"tensor on {t.device}, current device is "
            f"cuda:{torch.cuda.current_device()}: launch under "
            "torch.cuda.device(...) of the tensor's device")
    return torch.cuda.current_stream(t.device).cuda_stream


def tracing() -> bool:
    """True while ``torch.export`` or ``torch.compile`` traces the caller.
    The wrappers then call their ``torch.library`` operators (namespace
    ``raft_tpu_torch``, registered when ``raft_tpu_torch.kernels`` is
    imported), so a traced program carries the kernels; run eagerly they
    skip the operator's dispatch, tens of microseconds a call."""
    import torch

    return torch.compiler.is_compiling() or torch.compiler.is_exporting()


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = library().lib.raft_kernels_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} "
                           f"({msg})")


#: launches by (kernel, operand dtype) since the counts were last set to 0;
#: ``kernels.launch_dtypes`` reads them
dtype_launches: dict = {}
#: launches by (kernel, operand layout), the same way;
#: ``kernels.launch_layouts`` reads them
layout_launches: dict = {}


def count_launch(launches: dict, name: str, dtype, layout=None) -> None:
    """One launch of kernel ``name`` on operands of ``dtype``: its module's
    count, the count by dtype and, for a kernel that reads more than one
    layout, by ``layout``."""
    launches[name] += 1
    key = (name, str(dtype).removeprefix("torch."))
    dtype_launches[key] = dtype_launches.get(key, 0) + 1
    if layout is not None:
        key = (name, layout)
        layout_launches[key] = layout_launches.get(key, 0) + 1
