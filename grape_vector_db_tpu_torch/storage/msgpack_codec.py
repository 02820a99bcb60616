"""MessagePack in pure Python, for the port's file formats.

The JAX package writes its WAL frames, snapshots, backups and index
snapshots with ``msgpack.packb(x, use_bin_type=True)`` and reads them with
``msgpack.unpackb(raw, raw=False)``. The port has to write and read the same
bytes on machines without the msgpack package, so it carries this codec.

``packb`` produces msgpack's bytes exactly for the types those files hold:
``None``, ``bool``, ``int`` (every width and sign class; outside
[-2**63, 2**64) raises ``OverflowError``), ``float`` (always float64),
``str`` (fixstr, str8/16/32), ``bytes``-like (bin8/16/32), ``list`` and
``tuple`` (fixarray, array16/32) and ``dict`` (fixmap, map16/32, in the
dict's order). Subclasses of those pack as their base type, as msgpack does
(a ``str`` enum packs as its string). Any other type raises ``TypeError``.

``unpackb`` reads every format but the extension types, returning what
``msgpack.unpackb(raw, raw=False)`` returns: str for str, bytes for bin,
lists for arrays, dicts for maps whose keys must be str or bytes. Malformed,
truncated or trailing input raises ``ValueError``.

Both take msgpack's keywords for these settings (``use_bin_type=True``,
``raw=False``), so code written against the msgpack package runs on this
module unchanged; ``packb``'s ``default`` is msgpack's hook for the types it
refuses. Embedding vectors are long runs of floats, so both directions take
a fast route through numpy for them: an array of at least
``_FAST_MIN`` items that are all exactly ``float`` packs as one record array
of (0xcb, big-endian float64) pairs, and an array whose items are all 0xcb
floats unpacks from one strided view. The bytes and values are the slow
route's.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Optional, Tuple

import numpy as np

__all__ = ["packb", "unpackb"]

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_f = struct.Struct(">f")
_d = struct.Struct(">d")
# a run of float64 items: one format byte, then the value, big-endian
_F64_ITEMS = np.dtype([("t", "u1"), ("v", ">f8")])
_FAST_MIN = 16


def _pack_int(out: bytearray, v: int) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v <= 0xFF:
            out += b"\xcc" + _B.pack(v)
        elif v <= 0xFFFF:
            out += b"\xcd" + _H.pack(v)
        elif v <= 0xFFFFFFFF:
            out += b"\xce" + _I.pack(v)
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out += b"\xcf" + _Q.pack(v)
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -32:
        out.append(v & 0xFF)
    elif v >= -0x80:
        out += b"\xd0" + _b.pack(v)
    elif v >= -0x8000:
        out += b"\xd1" + _h.pack(v)
    elif v >= -0x80000000:
        out += b"\xd2" + _i.pack(v)
    elif v >= -0x8000000000000000:
        out += b"\xd3" + _q.pack(v)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, c8: int, c16: int,
              c32: int) -> None:
    """A str/bin/array/map header; ``c8`` is 0 where the format has no 8-bit
    length (arrays and maps), ``fix`` 0 where it has no fix form (bin)."""
    if fix and n <= fix_max:
        out.append(fix | n)
    elif c8 and n <= 0xFF:
        out.append(c8)
        out.append(n)
    elif n <= 0xFFFF:
        out.append(c16)
        out += _H.pack(n)
    elif n <= 0xFFFFFFFF:
        out.append(c32)
        out += _I.pack(n)
    else:
        raise ValueError(f"object too large to pack: {n}")


def _pack_floats(out: bytearray, o) -> bool:
    """Append a list or tuple whose items are all exactly ``float`` as
    msgpack packs it; False (nothing appended) for any other content."""
    if len(o) < _FAST_MIN or set(map(type, o)) != {float}:
        return False
    items = np.empty(len(o), _F64_ITEMS)
    items["t"] = 0xCB
    items["v"] = o
    _pack_len(out, len(o), 0x90, 15, 0, 0xDC, 0xDD)
    out += items.tobytes()
    return True


def _pack(out: bytearray, o: Any, default: Optional[Callable[[Any], Any]] = None) -> None:
    if o is None:
        out.append(0xC0)
    elif o is True:
        out.append(0xC3)
    elif o is False:
        out.append(0xC2)
    elif isinstance(o, int):
        _pack_int(out, int(o))
    elif isinstance(o, float):
        out.append(0xCB)
        out += _d.pack(o)
    elif isinstance(o, (bytes, bytearray)):
        _pack_len(out, len(o), 0, 0, 0xC4, 0xC5, 0xC6)
        out += o
    elif isinstance(o, str):
        raw = o.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 31, 0xD9, 0xDA, 0xDB)
        out += raw
    elif isinstance(o, dict):
        _pack_len(out, len(o), 0x80, 15, 0, 0xDE, 0xDF)
        for k, v in o.items():
            _pack(out, k, default)
            _pack(out, v, default)
    elif isinstance(o, (list, tuple)):
        if not _pack_floats(out, o):
            _pack_len(out, len(o), 0x90, 15, 0, 0xDC, 0xDD)
            for v in o:
                _pack(out, v, default)
    elif isinstance(o, memoryview):
        raw = o.tobytes()
        _pack_len(out, len(raw), 0, 0, 0xC4, 0xC5, 0xC6)
        out += raw
    elif default is not None:
        r = default(o)
        if type(r) is type(o):
            raise TypeError(f"can not serialize {type(o).__name__!r} object")
        _pack(out, r, default)
    else:
        raise TypeError(f"can not serialize {type(o).__name__!r} object")


def packb(o: Any, *, use_bin_type: bool = True,
          default: Optional[Callable[[Any], Any]] = None) -> bytes:
    """``msgpack.packb(o, use_bin_type=True, default=default)``: ``default``
    turns an object of a type msgpack refuses into one it packs."""
    if not use_bin_type:
        raise ValueError("only use_bin_type=True is supported")
    out = bytearray()
    _pack(out, o, default)
    return bytes(out)


_FIXED = {0xCA: _f, 0xCB: _d, 0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q,
          0xD0: _b, 0xD1: _h, 0xD2: _i, 0xD3: _q}
# format byte -> (kind, length format): str, bin, array and map with a length
_SIZED = {0xC4: ("bin", _B), 0xC5: ("bin", _H), 0xC6: ("bin", _I),
          0xD9: ("str", _B), 0xDA: ("str", _H), 0xDB: ("str", _I),
          0xDC: ("array", _H), 0xDD: ("array", _I),
          0xDE: ("map", _H), 0xDF: ("map", _I)}


def unpackb(data, *, raw: bool = False) -> Any:
    """``msgpack.unpackb(data, raw=False)``."""
    if raw:
        raise ValueError("only raw=False is supported")
    data = bytes(data)
    size = len(data)

    def short() -> ValueError:
        return ValueError("Unpack failed: incomplete input")

    def array(pos: int, n: int) -> Tuple[list, int]:
        if n >= _FAST_MIN and pos < size and data[pos] == 0xCB and pos + 9 * n <= size:
            items = np.frombuffer(data, _F64_ITEMS, n, pos)
            if (items["t"] == 0xCB).all():
                return items["v"].tolist(), pos + 9 * n
        out = []
        for _ in range(n):
            v, pos = one(pos)
            out.append(v)
        return out, pos

    def mapping(pos: int, n: int) -> Tuple[dict, int]:
        out = {}
        for _ in range(n):
            k, pos = one(pos)
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"{type(k).__name__} is not allowed for map key when "
                                 "strict_map_key=True")
            out[k], pos = one(pos)
        return out, pos

    def one(pos: int) -> Tuple[Any, int]:
        if pos >= size:
            raise ValueError("Unpack failed: incomplete input")
        c = data[pos]
        pos += 1
        if c <= 0x7F:
            return c, pos
        if c >= 0xE0:
            return c - 0x100, pos
        if c >= 0xA0:
            if c <= 0xBF:                          # fixstr
                end = pos + (c & 0x1F)
                if end > size:
                    raise short()
                return data[pos:end].decode("utf-8"), end
        elif c >= 0x90:
            return array(pos, c & 0x0F)
        elif c >= 0x80:
            return mapping(pos, c & 0x0F)
        if c == 0xC0:
            return None, pos
        if c == 0xC2:
            return False, pos
        if c == 0xC3:
            return True, pos
        fmt = _FIXED.get(c)
        if fmt is not None:
            end = pos + fmt.size
            if end > size:
                raise short()
            return fmt.unpack_from(data, pos)[0], end
        sized = _SIZED.get(c)
        if sized is not None:
            kind, lenfmt = sized
            if pos + lenfmt.size > size:
                raise short()
            n = lenfmt.unpack_from(data, pos)[0]
            pos += lenfmt.size
            if kind == "array":
                return array(pos, n)
            if kind == "map":
                return mapping(pos, n)
            end = pos + n
            if end > size:
                raise short()
            return (data[pos:end].decode("utf-8") if kind == "str" else data[pos:end]), end
        if 0xC7 <= c <= 0xC9 or 0xD4 <= c <= 0xD8:
            raise ValueError(f"msgpack extension type 0x{c:02x} is not supported")
        raise ValueError(f"invalid msgpack format byte 0x{c:02x}")

    obj, end = one(0)
    if end != size:
        raise ValueError("unpack(b) received extra data.")
    return obj
