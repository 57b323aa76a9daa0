"""The subset of MessagePack that checkpoint manifests use, so the port
needs no ``msgpack`` package: maps, arrays, str, int, float, bool, None
and bytes.

``packb`` writes the bytes ``msgpack.packb`` writes by default (the
smallest format for each value, str as str, bytes as bin, floats as
doubles, dict order kept); ``unpackb`` reads those formats back as
``msgpack.unpackb`` does by default (str keys and values, lists for
arrays).
"""
from __future__ import annotations

import struct


def _head(n: int, fix: int, fix_max: int, codes) -> bytes:
    """A length header: the fix format below ``fix_max``, else the first of
    ``codes`` (8-, 16-, 32-bit lengths; None where a width is absent)."""
    if n < fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


def _int(x: int) -> bytes:
    if 0 <= x < 0x80 or -0x20 <= x < 0:
        return struct.pack(">b" if x < 0 else ">B", x)
    if x > 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if x <= top:
                return bytes([code]) + struct.pack(fmt, x)
    else:
        for code, fmt, bottom in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                  (0xD2, ">i", -0x80000000),
                                  (0xD3, ">q", -0x8000000000000000)):
            if x >= bottom:
                return bytes([code]) + struct.pack(fmt, x)
    raise ValueError(f"msgpack: integer {x} out of range")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out += [_head(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB)), data]
    elif isinstance(obj, (bytes, bytearray)):
        out += [_head(len(obj), 0, 0, (0xC4, 0xC5, 0xC6)), bytes(obj)]
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), 0x90, 16, (None, 0xDC, 0xDD)))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, 16, (None, 0xDE, 0xDF)))
        for key, x in obj.items():
            _pack(key, out)
            _pack(x, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    out: list = []
    _pack(obj, out)
    return b"".join(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_LENGTHS = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xC4: ">B", 0xC5: ">H",
            0xC6: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: data ends early")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        code = self.take(1)[0]
        if code <= 0x7F or code >= 0xE0:
            return code if code <= 0x7F else code - 0x100
        if code == 0xC0:
            return None
        if code in (0xC2, 0xC3):
            return code == 0xC3
        if code in _FIXED:
            return self.unpack(_FIXED[code])
        if 0xA0 <= code <= 0xBF or code in (0xD9, 0xDA, 0xDB):
            n = code & 0x1F if code <= 0xBF else self.unpack(_LENGTHS[code])
            return self.take(n).decode("utf-8")
        if code in (0xC4, 0xC5, 0xC6):
            return self.take(self.unpack(_LENGTHS[code]))
        if 0x90 <= code <= 0x9F or code in (0xDC, 0xDD):
            n = code & 0x0F if code <= 0x9F else self.unpack(_LENGTHS[code])
            return [self.value() for _ in range(n)]
        if 0x80 <= code <= 0x8F or code in (0xDE, 0xDF):
            n = code & 0x0F if code <= 0x8F else self.unpack(_LENGTHS[code])
            out = {}
            for _ in range(n):
                key = self.value()
                out[key] = self.value()
            return out
        raise ValueError(f"msgpack: format 0x{code:02x} not in the subset")


def unpackb(data: bytes):
    reader = _Reader(data)
    obj = reader.value()
    if reader.pos != len(data):
        raise ValueError("msgpack: extra data after the value")
    return obj
