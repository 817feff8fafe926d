"""A minimal MessagePack codec for the subset that flax writes, so the port
reads and writes ``.tdn`` bundles without the ``msgpack`` and ``flax``
packages (the GPU machine has neither).

Covered: nil, bool, every int width, float64 (float32 decodes too), str,
bin, array and map; ext code 1 (a numpy array: the MessagePack encoding of
``[shape, dtype name, C-order bytes]``) and ext code 3 (a numpy scalar, the
same payload of a 0-d array), as ``flax/serialization.py``
``_ndarray_to_bytes`` and ``_msgpack_ext_unpack`` define them. The encoder
picks the shortest form for every value, as the ``msgpack`` package does,
so the bytes are the same as flax's for the same tree. flax's chunked
arrays (``__msgpack_chunked_array__``, written only for leaves above 2**30
bytes) raise.

Arrays decode as views of the input buffer: writable when the buffer is
(``bytearray``), read-only over ``bytes``.
"""

from __future__ import annotations

import struct
from typing import Any, Mapping

import numpy as np

__all__ = ["packb", "unpackb", "EXT_NDARRAY", "EXT_NPSCALAR"]

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


# ----------------------------------------------------------------- encoding


def packb(obj: Any) -> bytes:
    """obj -> MessagePack bytes. Maps keep their iteration order."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_int(v: int, out: bytearray) -> None:
    if -0x20 <= v < 0x80:
        out += struct.pack("b" if v < 0 else "B", v)
    elif 0x80 <= v <= 0xFF:
        out += struct.pack(">BB", 0xCC, v)
    elif -0x80 <= v < 0:
        out += struct.pack(">Bb", 0xD0, v)
    elif 0xFF < v <= 0xFFFF:
        out += struct.pack(">BH", 0xCD, v)
    elif -0x8000 <= v < -0x80:
        out += struct.pack(">Bh", 0xD1, v)
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xCE, v)
    elif -0x80000000 <= v < -0x8000:
        out += struct.pack(">Bi", 0xD2, v)
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out += struct.pack(">BQ", 0xCF, v)
    elif -0x8000000000000000 <= v < -0x80000000:
        out += struct.pack(">Bq", 0xD3, v)
    else:
        raise OverflowError(f"int {v} does not fit 64 bits")


def _header(n: int, fix_base: int, fix_max: int, codes, out: bytearray) -> None:
    """Length header: a fix form below fix_max, else 8/16/32-bit codes
    (None where the type has no 8-bit form)."""
    c8, c16, c32 = codes
    if n < fix_max:
        out.append(fix_base | n)
    elif c8 is not None and n <= 0xFF:
        out += struct.pack(">BB", c8, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", c16, n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", c32, n)
    else:
        raise ValueError(f"a MessagePack object of length {n} is too long")


def _bin_header(n: int, out: bytearray) -> None:
    if n <= 0xFF:
        out += struct.pack(">BB", 0xC4, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", 0xC5, n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xC6, n)
    else:
        raise ValueError(f"bin of {n} bytes is too long")


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured dtypes cannot be serialized")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n <= 0xFF:
        out += struct.pack(">BB", 0xC7, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", 0xC8, n)
    else:
        out += struct.pack(">BI", 0xC9, n)
    out += struct.pack("b", code)
    out += data


def _pack(obj: Any, out: bytearray) -> None:
    # numpy scalars first: np.float64 subclasses float and np.str_ str
    if isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    elif obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _bin_header(len(data), out)
        out += data
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, Mapping):
        _header(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r} object")


# ----------------------------------------------------------------- decoding


def unpackb(data) -> Any:
    """MessagePack bytes (any buffer) -> Python objects: maps as dicts,
    arrays as lists, ext 1 and 3 as numpy arrays and scalars."""
    view = memoryview(data).cast("B")
    obj, pos = _Reader(view).read(0)
    if pos != len(view):
        raise ValueError(f"{len(view) - pos} bytes of trailing data")
    return obj


def _dtype(name: str) -> np.dtype:
    try:
        return np.dtype(name)
    except TypeError:
        raise ValueError(f"unsupported array dtype {name!r}") from None


class _Reader:
    """Decodes one buffer; ``bin_views`` returns bin objects as zero-copy
    memoryviews (for array payloads)."""

    def __init__(self, view: memoryview, bin_views: bool = False):
        self.view = view
        self.bin_views = bin_views

    def _take(self, pos: int, n: int):
        end = pos + n
        if end > len(self.view):
            raise ValueError("truncated MessagePack data")
        return self.view[pos:end], end

    def _unpack(self, fmt: str, pos: int):
        size = struct.calcsize(fmt)
        raw, pos = self._take(pos, size)
        return struct.unpack(fmt, raw)[0], pos

    def _bin(self, pos: int, n: int):
        raw, pos = self._take(pos, n)
        return (raw if self.bin_views else bytes(raw)), pos

    def _str(self, pos: int, n: int):
        raw, pos = self._take(pos, n)
        return str(raw, "utf-8"), pos

    def _array(self, pos: int, n: int):
        items = []
        for _ in range(n):
            v, pos = self.read(pos)
            items.append(v)
        return items, pos

    def _map(self, pos: int, n: int):
        out = {}
        for _ in range(n):
            k, pos = self.read(pos)
            v, pos = self.read(pos)
            out[k] = v
        if _CHUNKED in out:
            raise ValueError("flax chunked arrays (leaves above 2**30 bytes) "
                             "are not supported")
        return out, pos

    def _ext(self, pos: int, n: int):
        code, pos = self._unpack("b", pos)
        payload, pos = self._take(pos, n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported MessagePack ext type {code}")
        (shape, name, buf), end = _Reader(payload, bin_views=True).read(0)
        if end != len(payload):
            raise ValueError("trailing bytes in an array payload")
        arr = np.frombuffer(buf, dtype=_dtype(name)).reshape(tuple(shape))
        return (arr[()] if code == EXT_NPSCALAR else arr), pos

    def read(self, pos: int):
        """(object, next position) of the object at pos."""
        if pos >= len(self.view):
            raise ValueError("truncated MessagePack data")
        b = self.view[pos]
        pos += 1
        if b <= 0x7F:
            return b, pos
        if b >= 0xE0:
            return b - 0x100, pos
        if 0x80 <= b <= 0x8F:
            return self._map(pos, b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(pos, b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(pos, b & 0x1F)
        if b == 0xC0:
            return None, pos
        if b in (0xC2, 0xC3):
            return b == 0xC3, pos
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self._unpack(ints[b], pos)
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                   0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                   0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in lengths:
            n, pos = self._unpack(lengths[b], pos)
            if b <= 0xC6:
                return self._bin(pos, n)
            if b <= 0xC9:
                return self._ext(pos, n)
            if b <= 0xDB:
                return self._str(pos, n)
            if b <= 0xDD:
                return self._array(pos, n)
            return self._map(pos, n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(pos, fixext[b])
        raise ValueError(f"unsupported MessagePack type byte 0x{b:02x}")
