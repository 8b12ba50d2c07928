"""The subset of MessagePack that an artifact's ``__meta__`` block uses.

The reference writes the meta block with ``msgpack.packb`` and reads it
with ``msgpack.unpackb`` (``repro/core/serialize.py``).  The port carries
its own codec so that it needs no msgpack package: ``packb`` gives the
bytes ``msgpack.packb`` gives at its defaults (``use_bin_type=True``,
``use_single_float=False``), and ``unpackb`` the objects
``msgpack.unpackb`` gives at its (``raw=False``, ``strict_map_key=True``,
``use_list=True``).

Types: nil, bool, int (-2**63 .. 2**64 - 1), float (always written as
float64; float32 is read too), str, array (list or tuple; read as list)
and map with str keys.  Everything else is refused with an error, never
guessed at: other Python types and numpy scalars (cast them to Python
numbers first), bin and ext, non-str map keys, truncated input and
trailing bytes.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["packb", "unpackb"]


def _head(out: bytearray, n: int, fix: int, fix_limit: int,
          codes: tuple) -> None:
    """The header of a str, array or map of length ``n``: its fix form
    below ``fix_limit``, else the smallest of ``codes`` (8-, 16- and
    32-bit lengths, None where the family has no 8-bit form)."""
    if n < fix_limit:
        out.append(fix | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    elif n < 1 << 32:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"length {n} does not fit MessagePack's 32 bits")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for code, fmt, top in ((0xcc, ">BB", 1 << 8), (0xcd, ">BH", 1 << 16),
                               (0xce, ">BI", 1 << 32),
                               (0xcf, ">BQ", 1 << 64)):
            if v < top:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(f"integer {v} is out of MessagePack's range")
    else:
        for code, fmt, low in ((0xd0, ">Bb", -(1 << 7)),
                               (0xd1, ">Bh", -(1 << 15)),
                               (0xd2, ">Bi", -(1 << 31)),
                               (0xd3, ">Bq", -(1 << 63))):
            if v >= low:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(f"integer {v} is out of MessagePack's range")


def _pack(out: bytearray, obj) -> None:
    if isinstance(obj, np.generic):
        raise TypeError(f"cannot serialize numpy scalar {obj!r} "
                        f"({type(obj).__name__}); cast it to a Python number")
    if obj is None:
        out.append(0xc0)
    elif isinstance(obj, bool):          # before int: bool is an int
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xcb, obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _head(out, len(data), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out += data
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, (None, 0xdc, 0xdd))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, (None, 0xde, 0xdf))
        for key, val in obj.items():
            if not isinstance(key, str):
                raise TypeError(f"map key {key!r} is not a str")
            _pack(out, key)
            _pack(out, val)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} object "
                        f"{obj!r}")


def packb(obj) -> bytes:
    """``obj`` as MessagePack bytes, equal to ``msgpack.packb(obj)``."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"truncated MessagePack input: {n} bytes wanted "
                             f"at offset {self.pos} of {len(self.data)}")
        view = self.data[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# code -> struct format of the value (ints, floats) or of the length
# (str, array, map) that follows it
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_STRS = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
_ARRAYS = {0xdc: ">H", 0xdd: ">I"}
_MAPS = {0xde: ">H", 0xdf: ">I"}


def _unpack(r: _Reader):
    code = r.unpack(">B")
    if code <= 0x7f:
        return code
    if code >= 0xe0:
        return code - 0x100
    if 0xa0 <= code <= 0xbf:
        return _str(r, code & 0x1f)
    if 0x90 <= code <= 0x9f:
        return [_unpack(r) for _ in range(code & 0x0f)]
    if 0x80 <= code <= 0x8f:
        return _map(r, code & 0x0f)
    if code == 0xc0:
        return None
    if code in (0xc2, 0xc3):
        return code == 0xc3
    if code in _SCALARS:
        return r.unpack(_SCALARS[code])
    if code in _STRS:
        return _str(r, r.unpack(_STRS[code]))
    if code in _ARRAYS:
        return [_unpack(r) for _ in range(r.unpack(_ARRAYS[code]))]
    if code in _MAPS:
        return _map(r, r.unpack(_MAPS[code]))
    kind = "bin" if 0xc4 <= code <= 0xc6 else \
        "ext" if 0xc7 <= code <= 0xc9 or 0xd4 <= code <= 0xd8 else "unused"
    raise ValueError(f"MessagePack type 0x{code:02x} ({kind}) at offset "
                     f"{r.pos - 1} is not part of the meta block's subset")


def _str(r: _Reader, n: int) -> str:
    return bytes(r.take(n)).decode("utf-8")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _unpack(r)
        if not isinstance(key, str):
            raise ValueError(f"map key {key!r} is not a str")
        out[key] = _unpack(r)
    return out


def unpackb(data: bytes):
    """The object ``data`` encodes, equal to ``msgpack.unpackb(data)``;
    ValueError on truncated input or trailing bytes."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the "
                         f"MessagePack object")
    return obj
