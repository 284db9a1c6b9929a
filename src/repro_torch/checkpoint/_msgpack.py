"""The subset of MessagePack (https://github.com/msgpack/msgpack/blob/master/spec.md)
that the checkpoints use: nil, bool, int, float, str, bin, array and map.

The machine with the card has no ``msgpack`` package, so the port carries
this codec.  ``packb`` writes what ``msgpack.packb(obj, use_bin_type=True)``
writes for these types (the smallest int and length encodings, floats as
float64, bytes as bin), so a file is byte for byte the reference's;
``Unpacker`` reads them back, one object at a time from a stream (float32
too, which other writers emit), and raises ``OutOfData`` at a clean end of
the stream and ``ValueError`` for a truncated or unknown object.
"""
from __future__ import annotations

import struct


class OutOfData(Exception):
    """The stream ended between two objects."""


def _len_header(n: int, fix: int | None, fix_max: int, codes) -> bytes:
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, limit in codes:
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} is too large")


def _int(n: int) -> bytes:
    if 0 <= n < 128:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < limit:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if n >= -limit:
                return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"msgpack: integer {n} does not fit in 64 bits")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARR = ((None, "", 0), (0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((None, "", 0), (0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_len_header(len(data), 0xA0, 31, _STR))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        out.append(bin_header(len(data)))
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        out.append(_len_header(len(obj), 0x90, 15, _ARR))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_len_header(len(obj), 0x80, 15, _MAP))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot serialize {type(obj).__name__}")


def bin_header(n: int) -> bytes:
    """The header of an n-byte bin, which ``packb`` writes before the bytes
    (so that a large buffer can be written after it without a copy)."""
    return _len_header(n, None, -1, _BIN)


def packb(obj) -> bytes:
    """``obj`` as MessagePack bytes."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class Unpacker:
    """Objects read one at a time from a binary stream ``f``."""

    def __init__(self, f):
        self._f = f

    def _read(self, n: int, first: bool = False) -> bytes:
        data = self._f.read(n)
        if len(data) != n:
            if first and not data:
                raise OutOfData()
            raise ValueError(f"msgpack: the stream ends inside an object ({len(data)} of "
                             f"{n} bytes)")
        return data

    def _num(self, fmt: str):
        return struct.unpack(fmt, self._read(struct.calcsize(fmt)))[0]

    def unpack(self):
        """The next object; ``OutOfData`` at the end of the stream."""
        return self._obj(first=True)

    def _obj(self, first: bool = False):
        b = self._read(1, first)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self._num(fixed[b])
        sized = {0xC4: (">B", self._bin), 0xC5: (">H", self._bin), 0xC6: (">I", self._bin),
                 0xD9: (">B", self._str), 0xDA: (">H", self._str), 0xDB: (">I", self._str),
                 0xDC: (">H", self._array), 0xDD: (">I", self._array),
                 0xDE: (">H", self._map), 0xDF: (">I", self._map)}
        if b in sized:
            fmt, read = sized[b]
            return read(self._num(fmt))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def _bin(self, n: int) -> bytes:
        return self._read(n)

    def unpack_bin_into(self, buf: memoryview) -> int:
        """Read the next object, which must be a bin no longer than ``buf``,
        straight into the front of ``buf`` (no copy); returns its length."""
        b = self._read(1)[0]
        fmt = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}.get(b)
        if fmt is None:
            raise ValueError(f"msgpack: expected a bin, got type byte 0x{b:02x}")
        n = self._num(fmt)
        if n > len(buf):
            raise ValueError(f"msgpack: a bin of {n} bytes where {len(buf)} remain")
        got = self._f.readinto(buf[:n])
        if got != n:
            raise ValueError(f"msgpack: the stream ends inside an object ({got} of {n} bytes)")
        return n

    def _str(self, n: int) -> str:
        return self._read(n).decode("utf-8")

    def _array(self, n: int) -> list:
        return [self._obj() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self._obj()
            out[k] = self._obj()
        return out


def unpackb(data: bytes):
    """The single object of ``data``; raises on trailing bytes."""
    import io

    f = io.BytesIO(data)
    obj = Unpacker(f).unpack()
    if f.read(1):
        raise ValueError("msgpack: trailing data after the object")
    return obj
