"""The msgpack subset flax writes, read and written with numpy only.

The JAX trainer saves its weights with ``flax.serialization.to_bytes``
(``raft_tpu/tools/convert.py:193``): a msgpack map of nested string-keyed
maps whose leaves are msgpack extension objects. The port may not import
flax, and the card's machine has neither flax nor the ``msgpack`` package,
so this module is its own codec for that subset
(``flax/serialization.py:237-390``):

- nil, bool, ints, floats, str, bin, arrays and maps, in every width;
- ext 1, an ndarray: its payload is itself msgpack, ``(shape, dtype name,
  C-order bytes)``; ext 3, a numpy scalar (the same payload, taken with
  ``[()]``); ext 2, a complex ``(real, imag)``;
- ``__msgpack_chunked_array__`` maps, which flax writes for a leaf of more
  than :data:`MAX_CHUNK_SIZE` bytes, joined back into one array.

numpy has no ``bfloat16``: such a leaf decodes through a ``uint16`` view
into a ``torch.bfloat16`` tensor, and a ``torch.bfloat16`` tensor encodes
under that name. Every other array leaf decodes to a numpy array.

:func:`unpackb` raises :class:`CorruptCheckpointError` on a buffer it
cannot read whole (truncated, trailing bytes, an unknown type byte or
extension code, an array whose bytes do not fill its shape): it never
returns part of a tree. :func:`packb` writes the encodings the ``msgpack``
package picks (the smallest width that holds each value, floats as
doubles) with each map's keys in order: for the same tree its bytes are
flax's ``msgpack_serialize``'s.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

#: flax's chunking threshold (``serialization.py:318``): an array leaf of
#: more bytes is written as a chunked map
MAX_CHUNK_SIZE = 2 ** 30

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
#: type byte -> value of nil and the bools; struct format of the numbers;
#: struct format of the length of bin, ext, str, array and map
_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_SIZED = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H",
          0xC9: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H",
          0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}


class CorruptCheckpointError(RuntimeError):
    """A checkpoint file failed its integrity check or could not be
    decoded whole."""


class _Reader:
    """Recursive descent over one msgpack buffer."""

    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if n < 0 or end > len(self.buf):
            raise CorruptCheckpointError(
                f"msgpack buffer truncated: {n} bytes wanted at offset "
                f"{self.pos} of {len(self.buf)}")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as e:
            raise CorruptCheckpointError(f"msgpack str not utf-8: {e}") from e

    def value(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map_(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.str_(t & 0x1F)
        if t in _SIMPLE:
            return _SIMPLE[t]
        if t in _FIXED:
            return self.unpack(_FIXED[t])
        if t in _SIZED:
            n = self.unpack(_SIZED[t])
            if t <= 0xC6:
                return bytes(self.take(n))
            if t <= 0xC9:
                return self.ext(n)
            if t <= 0xDB:
                return self.str_(n)
            if t <= 0xDD:
                return self.array(n)
            return self.map_(n)
        if 0xD4 <= t <= 0xD8:
            return self.ext(1 << (t - 0xD4))
        raise CorruptCheckpointError(
            f"msgpack type byte 0x{t:02x} at offset {self.pos - 1} is not "
            "one this decoder reads")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(payload)[()]
        if code == _EXT_COMPLEX:
            pair = unpackb(payload)
            if not (isinstance(pair, list) and len(pair) == 2):
                raise CorruptCheckpointError("msgpack complex payload is not "
                                             "a (real, imag) pair")
            return complex(pair[0], pair[1])
        raise CorruptCheckpointError(
            f"msgpack extension code {code} is not one flax writes "
            "(1 ndarray, 2 complex, 3 numpy scalar)")


def _ndarray_from_bytes(payload: bytes):
    """flax's ``_ndarray_from_bytes``: msgpack ``(shape, dtype name,
    C-order bytes)``; bfloat16 through a uint16 view into torch."""
    item = _decode(payload)
    if not (isinstance(item, list) and len(item) == 3
            and isinstance(item[0], list) and isinstance(item[2], bytes)):
        raise CorruptCheckpointError("msgpack ndarray payload is not "
                                     "(shape, dtype, bytes)")
    shape, name, data = item
    if isinstance(name, bytes):
        name = name.decode("ascii", "replace")
    bf16 = name == "bfloat16"
    try:
        dtype = np.dtype(np.uint16 if bf16 else name)
    except TypeError as e:
        raise CorruptCheckpointError(f"msgpack ndarray dtype {name!r}: "
                                     f"{e}") from e
    if (not all(isinstance(d, int) and d >= 0 for d in shape)
            or dtype.hasobject
            or len(data) != int(np.prod(shape)) * dtype.itemsize):
        raise CorruptCheckpointError(
            f"msgpack ndarray of shape {shape} and dtype {name} holds "
            f"{len(data)} bytes")
    arr = np.frombuffer(data, dtype=dtype).reshape(shape)
    if bf16:
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    return arr


def _decode(data: bytes) -> Any:
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise CorruptCheckpointError(
            f"msgpack buffer has {len(r.buf) - r.pos} bytes after its "
            "value")
    return out


def _unchunk(tree: Any) -> Any:
    """flax's ``_unchunk_array_leaves_in_place``: chunked maps joined."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        try:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        except (KeyError, TypeError, ValueError, IndexError,
                RuntimeError) as e:
            raise CorruptCheckpointError(
                f"malformed chunked array leaf: {e!r}") from e
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore`` returns for
    ``data``: nested dicts (and lists) with numpy array, numpy scalar,
    ``torch.bfloat16`` tensor and Python scalar leaves."""
    return _unchunk(_decode(data))


# -- encoding ----------------------------------------------------------------


def _head(out: bytearray, n: int, fix: Tuple[int, int], w8: int,
          w16: int, w32: int) -> None:
    """The header of a str/bin/array/map of length ``n``: the fix form
    when ``fix = (base, limit)`` holds it, else the smallest width."""
    base, limit = fix
    if n <= limit:
        out.append(base | n)
    elif w8 and n <= 0xFF:
        out += struct.pack(">BB", w8, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", w16, n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", w32, n)
    else:
        raise ValueError(f"msgpack object of {n} elements or bytes is too "
                         "large")


def _int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v > 0:
        for t, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                            (0xCE, ">I", 0xFFFFFFFF),
                            (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                out.append(t)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"int {v} does not fit msgpack")
    else:
        for t, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                            (0xD2, ">i", -0x80000000),
                            (0xD3, ">q", -0x8000000000000000)):
            if v >= low:
                out.append(t)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"int {v} does not fit msgpack")


def _ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fix:
        out.append(fix[n])
    elif n <= 0xFF:
        out += struct.pack(">BB", 0xC7, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", 0xC8, n)
    else:
        out += struct.pack(">BI", 0xC9, n)
    out += struct.pack(">b", code)
    out += payload


def _array_parts(x) -> Tuple[tuple, str, bytes]:
    """(shape, dtype name, C-order bytes) of a numpy array or tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return (tuple(x.shape), "bfloat16",
                    x.view(torch.uint16).numpy().tobytes())
        x = x.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serialized")
    return x.shape, x.dtype.name, x.tobytes("C")


def _ndarray_to_bytes(x) -> bytes:
    shape, name, data = _array_parts(x)
    return packb((tuple(int(d) for d in shape), name, data))


def _pack(out: bytearray, v: Any, in_order: bool = False) -> None:
    """``v`` onto ``out``; a dict's keys sorted (as jax's tree_map leaves
    a tree flax serializes), a chunked leaf's maps in flax's insertion
    order (``in_order``)."""
    if v is None:
        out.append(0xC0)
    elif v is True or v is False:
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, int) and not isinstance(v, np.generic):
        _int(out, int(v))
    elif isinstance(v, float) and not isinstance(v, np.generic):
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        _head(out, len(b), (0xA0, 31), 0xD9, 0xDA, 0xDB)
        out += b
    elif isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        _head(out, len(b), (0xC4, -1), 0xC4, 0xC5, 0xC6)
        out += b
    elif isinstance(v, (np.ndarray, torch.Tensor)):
        nbytes = (v.numel() * v.element_size() if isinstance(v, torch.Tensor)
                  else v.nbytes)
        if nbytes > MAX_CHUNK_SIZE:
            _pack(out, _chunk(v), in_order=True)
        else:
            _ext(out, _EXT_NDARRAY, _ndarray_to_bytes(v))
    elif isinstance(v, np.generic):
        _ext(out, _EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(v)))
    elif isinstance(v, complex):
        _ext(out, _EXT_COMPLEX, packb((v.real, v.imag)))
    elif isinstance(v, dict):
        _head(out, len(v), (0x80, 15), 0, 0xDE, 0xDF)
        for k in (v if in_order else sorted(v)):
            _pack(out, k)
            _pack(out, v[k], in_order)
    elif isinstance(v, (list, tuple)):
        _head(out, len(v), (0x90, 15), 0, 0xDC, 0xDD)
        for x in v:
            _pack(out, x)
    else:
        raise TypeError(f"cannot msgpack a {type(v).__name__}")


def _chunk(x) -> dict:
    """flax's ``_chunk``: a flat array cut into pieces of at most
    :data:`MAX_CHUNK_SIZE` bytes."""
    itemsize = (x.element_size() if isinstance(x, torch.Tensor)
                else x.dtype.itemsize)
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.numel() if isinstance(x, torch.Tensor) else flat.size
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def packb(tree: Any) -> bytes:
    """msgpack bytes of ``tree`` as ``flax.serialization.msgpack_serialize``
    writes them: dicts, lists and tuples, Python scalars, str and bytes;
    numpy arrays and tensors as ext 1 (chunked above
    :data:`MAX_CHUNK_SIZE` bytes), numpy scalars as ext 3, complex as
    ext 2."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)
