"""The subset of MessagePack the checkpoint manifest uses, with no package.

Encodes and decodes ints (-2**63 to 2**64 - 1), str, lists and tuples
(as arrays) and maps, in the smallest format for each value,
as ``msgpack.packb`` does (``use_bin_type=True``): so the bytes are
``msgpack.packb``'s and ``msgpack.unpackb`` reads them, and this reads
what ``msgpack.packb`` writes for such values
(tests/test_torch_checkpoint.py).  Other types are refused.
"""
from __future__ import annotations

import struct


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, hi in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                              (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < hi:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, lo in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                              (0xD2, ">i", -(1 << 31)),
                              (0xD3, ">q", -(1 << 63))):
            if v >= lo:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"int {v} does not fit in 64 bits")


def _header(n: int, fix: int, fix_max: int, codes) -> bytes:
    """The length header of a str, array or map of n items."""
    if n < fix_max:
        return bytes([fix | n])
    for code, fmt, hi in codes:
        if n < hi:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"{n} items is too long")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_ARR = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))


def packb(obj) -> bytes:
    """The MessagePack bytes of ``obj``."""
    if isinstance(obj, int) and not isinstance(obj, bool):
        return _int(obj)
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        return _header(len(raw), 0xA0, 32, _STR) + raw
    if isinstance(obj, (list, tuple)):
        return _header(len(obj), 0x90, 16, _ARR) + b"".join(
            packb(x) for x in obj)
    if isinstance(obj, dict):
        return _header(len(obj), 0x80, 16, _MAP) + b"".join(
            packb(k) + packb(v) for k, v in obj.items())
    raise TypeError(f"cannot pack {type(obj).__name__}")


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENGTHS = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I",
            0xDE: ">H", 0xDF: ">I"}


def _unpack(buf: bytes, pos: int):
    code = buf[pos]
    pos += 1
    if code < 0x80:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if code in _FIXED:
        fmt = _FIXED[code]
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    if code in _LENGTHS:
        fmt = _LENGTHS[code]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
        kind = ("str" if code <= 0xDB else "arr" if code <= 0xDD else "map")
    elif 0xA0 <= code < 0xC0:
        n, kind = code & 0x1F, "str"
    elif 0x90 <= code < 0xA0:
        n, kind = code & 0x0F, "arr"
    elif 0x80 <= code < 0x90:
        n, kind = code & 0x0F, "map"
    else:
        raise ValueError(f"msgpack type 0x{code:02x} is not supported")
    if kind == "str":
        return buf[pos:pos + n].decode("utf-8"), pos + n
    if kind == "arr":
        out = []
        for _ in range(n):
            item, pos = _unpack(buf, pos)
            out.append(item)
        return out, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        out[k], pos = _unpack(buf, pos)
    return out, pos


def unpackb(buf: bytes):
    """The value of the MessagePack bytes ``buf`` (arrays as lists)."""
    obj, pos = _unpack(bytes(buf), 0)
    if pos != len(buf):
        raise ValueError("extra bytes after the msgpack value")
    return obj
