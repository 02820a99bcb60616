"""XXH64 in pure Python, for shard routing without the xxhash package.

The JAX package routes every document to its shard by
``xxhash.xxh64_intdigest(id)`` (``distributed/shard.py``). The machine with the
card has no xxhash, and a cluster of both packages must place each id on the
same shard, so the port carries the hash: XXH64 with seed 0 over the UTF-8
bytes of a ``str``, as an unsigned 64-bit int, equal to
``xxhash.xxh64_intdigest``.

Arithmetic is on Python ints masked to 64 bits. Ids are short (tens of
bytes), so the 32-byte stripe loop rarely runs; the tail walks 8-byte lanes,
one 4-byte word and single bytes as the specification does.
"""

from __future__ import annotations

import struct

__all__ = ["xxh64_intdigest"]

_M = 0xFFFFFFFFFFFFFFFF
_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5
_LANE = struct.Struct("<Q").unpack_from
_WORD = struct.Struct("<I").unpack_from
_STRIPE = struct.Struct("<4Q").unpack_from


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M
    return (((acc << 31) | (acc >> 33)) & _M) * _P1 & _M


def _merge(h: int, v: int) -> int:
    return ((h ^ _round(0, v)) * _P1 + _P4) & _M


def xxh64_intdigest(key: str) -> int:
    """``xxhash.xxh64_intdigest(key)``: seed 0."""
    data = key.encode("utf-8")
    n = len(data)
    pos = 0
    if n >= 32:
        v1 = (_P1 + _P2) & _M
        v2 = _P2
        v3 = 0
        v4 = -_P1 & _M
        end = n - 32
        while pos <= end:
            a, b, c, d = _STRIPE(data, pos)
            v1 = _round(v1, a)
            v2 = _round(v2, b)
            v3 = _round(v3, c)
            v4 = _round(v4, d)
            pos += 32
        h = (((v1 << 1) | (v1 >> 63)) + ((v2 << 7) | (v2 >> 57))
             + ((v3 << 12) | (v3 >> 52)) + ((v4 << 18) | (v4 >> 46))) & _M
        h = _merge(_merge(_merge(_merge(h, v1), v2), v3), v4)
    else:
        h = _P5
    h = (h + n) & _M
    while pos + 8 <= n:
        k = _LANE(data, pos)[0] * _P2 & _M
        k = (((k << 31) | (k >> 33)) & _M) * _P1 & _M
        h ^= k
        h = ((((h << 27) | (h >> 37)) & _M) * _P1 + _P4) & _M
        pos += 8
    if pos + 4 <= n:
        h ^= _WORD(data, pos)[0] * _P1 & _M
        h = ((((h << 23) | (h >> 41)) & _M) * _P2 + _P3) & _M
        pos += 4
    while pos < n:
        h ^= data[pos] * _P5 & _M
        h = (((h << 11) | (h >> 53)) & _M) * _P1 & _M
        pos += 1
    h ^= h >> 33
    h = h * _P2 & _M
    h ^= h >> 29
    h = h * _P3 & _M
    return h ^ (h >> 32)
