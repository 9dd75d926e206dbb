"""A small msgpack codec for the subset a checkpoint manifest uses: maps,
arrays (lists and tuples), str, int, float, bool and nil.

``packb`` gives the bytes ``msgpack.packb`` gives for these types with its
defaults (the smallest int encoding, float as float64, str as UTF-8 str
formats); ``unpackb`` reads them back as ``msgpack.unpackb`` does (arrays as
lists, str decoded), and also reads float32 and every int width.  The
machine with the card has no ``msgpack`` package, hence this copy.
"""

from __future__ import annotations

import struct


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 1 << 8:
            out += struct.pack(">BB", 0xD9, n)
        elif n < 1 << 16:
            out += struct.pack(">BH", 0xDA, n)
        else:
            out += struct.pack(">BI", 0xDB, n)
        out += data
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), 0x90, 0xDC, out)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _header(len(obj), 0x80, 0xDE, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"manifest msgpack: cannot pack {type(obj).__name__}")


def _header(n: int, fix: int, wide: int, out: bytearray) -> None:
    """An array or map header: fix form under 16 entries, else 16 or 32
    bits (``wide`` is the 16-bit code, ``wide + 1`` the 32-bit one)."""
    if n < 16:
        out.append(fix | n)
    elif n < 1 << 16:
        out += struct.pack(">BH", wide, n)
    else:
        out += struct.pack(">BI", wide + 1, n)


def _pack_int(x: int, out: bytearray) -> None:
    if 0 <= x < 128:
        out.append(x)
    elif -32 <= x < 0:
        out.append(x & 0xFF)
    elif x >= 0:
        for code, fmt, bits in ((0xCC, "B", 8), (0xCD, "H", 16), (0xCE, "I", 32),
                                (0xCF, "Q", 64)):
            if x < 1 << bits:
                out += struct.pack(">B" + fmt, code, x)
                return
        raise OverflowError(f"manifest msgpack: int {x} too large")
    else:
        for code, fmt, bits in ((0xD0, "b", 8), (0xD1, "h", 16), (0xD2, "i", 32),
                                (0xD3, "q", 64)):
            if x >= -(1 << (bits - 1)):
                out += struct.pack(">B" + fmt, code, x)
                return
        raise OverflowError(f"manifest msgpack: int {x} too small")


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# fixed-width codes: (struct format, byte count)
_FIXED = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1), 0xCD: (">H", 2),
          0xCE: (">I", 4), 0xCF: (">Q", 8), 0xD0: (">b", 1), 0xD1: (">h", 2),
          0xD2: (">i", 4), 0xD3: (">q", 8)}
# length-prefixed codes: (kind, length format, length byte count)
_SIZED = {0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
          0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
          0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4)}


def _unpack(data: bytes, i: int):
    """(object, next offset) of the msgpack object at data[i]."""
    if i >= len(data):
        raise ValueError("manifest msgpack: truncated")
    c = data[i]
    i += 1
    if c < 0x80:
        return c, i
    if c >= 0xE0:
        return c - 0x100, i
    if c in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[c], i
    if c in _FIXED:
        fmt, n = _FIXED[c]
        if i + n > len(data):
            raise ValueError("manifest msgpack: truncated")
        return struct.unpack(fmt, data[i:i + n])[0], i + n
    if 0xA0 <= c <= 0xBF:
        kind, n = "str", c & 0x1F
    elif 0x90 <= c <= 0x9F:
        kind, n = "array", c & 0x0F
    elif 0x80 <= c <= 0x8F:
        kind, n = "map", c & 0x0F
    elif c in _SIZED:
        kind, fmt, w = _SIZED[c]
        if i + w > len(data):
            raise ValueError("manifest msgpack: truncated")
        n = struct.unpack(fmt, data[i:i + w])[0]
        i += w
    else:
        raise ValueError(f"manifest msgpack: unsupported type code {c:#04x}")
    if kind == "str":
        if i + n > len(data):
            raise ValueError("manifest msgpack: truncated")
        return data[i:i + n].decode("utf-8"), i + n
    if kind == "array":
        items = []
        for _ in range(n):
            x, i = _unpack(data, i)
            items.append(x)
        return items, i
    out = {}
    for _ in range(n):
        k, i = _unpack(data, i)
        out[k], i = _unpack(data, i)
    return out, i


def unpackb(data: bytes):
    obj, end = _unpack(bytes(data), 0)
    if end != len(data):
        raise ValueError(f"manifest msgpack: {len(data) - end} bytes after the object")
    return obj
