"""The port's pure-Python msgpack codec against the msgpack package.

``packb`` must give ``msgpack.packb(x, use_bin_type=True)``'s bytes exactly
and ``unpackb`` must give ``msgpack.unpackb(b, raw=False)``'s value, at
every width boundary of every format the port's files hold and on nested
values drawn by hypothesis. Types msgpack refuses raise ``TypeError``.
"""

import enum
import math
import struct

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from grape_vector_db_tpu_torch.storage.msgpack_codec import packb, unpackb


def _ref(x) -> bytes:
    return msgpack.packb(x, use_bin_type=True)


def _same(x):
    raw = _ref(x)
    assert packb(x) == raw
    got, want = unpackb(raw), msgpack.unpackb(raw, raw=False)
    assert type(got) is type(want)
    if isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert got == want


INT_EDGES = sorted({v for b in (0, 5, 7, 8, 15, 16, 31, 32, 63, 64)
                    for v in (2**b - 1, 2**b, 2**b + 1, -(2**b) - 1, -(2**b), -(2**b) + 1)
                    if -(2**63) <= v < 2**64} | {-32, -33, 127, 128})


@pytest.mark.parametrize("v", INT_EDGES)
def test_int_boundaries(v):
    _same(v)


@pytest.mark.parametrize("v", [2**64, -(2**63) - 1, 10**30])
def test_int_out_of_range_raises_like_msgpack(v):
    with pytest.raises(OverflowError):
        _ref(v)
    with pytest.raises(OverflowError):
        packb(v)


@pytest.mark.parametrize("v", [0.0, -0.0, 1.5, -2.25e-300, 1e308, float("inf"), float("-inf"),
                               float("nan"), np.float64(3.5)])
def test_floats_are_float64(v):
    _same(v)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 255, 256, 65535, 65536, 70000])
def test_str_and_bin_lengths(n):
    _same("a" * n)
    _same(b"\x00" * n)
    _same(bytearray(b"\x01" * n))


@pytest.mark.parametrize("n", [0, 1, 15, 16, 65535, 65536])
def test_array_and_map_lengths(n):
    _same(list(range(n % 300)) + [None] * (n - n % 300))
    _same(tuple([True] * n))
    _same({f"k{i}": i for i in range(n)})


@pytest.mark.parametrize("v", [None, True, False, "é漢字", "\U0001F600", memoryview(b"abc"),
                               {"nested": [{"a": b"b"}, [1, [2, [3]]]], "x": None}])
def test_special_values(v):
    _same(v)


def test_subclasses_pack_as_their_base():
    class S(str, enum.Enum):
        A = "alpha"

    class I(enum.IntEnum):
        B = 300

    for v in (S.A, I.B, {"k": S.A, "v": [I.B]}):
        assert packb(v) == _ref(v)


@pytest.mark.parametrize("v", [np.int64(3), np.float32(1.0), {1, 2}, object(), np.zeros(2),
                               [1, {2}], {"a": np.int32(1)}])
def test_refused_types_raise_type_error(v):
    with pytest.raises(TypeError):
        _ref(v)
    with pytest.raises(TypeError):
        packb(v)


@pytest.mark.parametrize("raw", [b"", b"\x91", b"\xa3ab", b"\xc1", b"\x91\x01\x00",
                                 b"\x81\x01\x02", b"\x81\x91\x01\x02", b"\xc5\x00"])
def test_bad_input_raises_value_error(raw):
    with pytest.raises(ValueError):
        msgpack.unpackb(raw, raw=False)
    with pytest.raises(ValueError):
        unpackb(raw)


@pytest.mark.parametrize("raw", [b"\xd4\x01\x00", b"\xc7\x01\x05\x00"])
def test_extension_types_raise(raw):
    """msgpack reads these as ExtType; no file of the port holds one, so the
    codec refuses them."""
    assert isinstance(msgpack.unpackb(raw, raw=False), msgpack.ExtType)
    with pytest.raises(ValueError):
        unpackb(raw)


def test_reads_float32_as_msgpack_does():
    raw = msgpack.packb(1.25, use_bin_type=True, use_single_float=True)
    assert raw[0] == 0xCA and unpackb(raw) == msgpack.unpackb(raw) == 1.25


_leaves = (st.none() | st.booleans() | st.integers(min_value=-(2**63), max_value=2**64 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=300) | st.binary(max_size=300))
_values = st.recursive(
    _leaves,
    lambda inner: (st.lists(inner, max_size=20) | st.tuples(inner, inner)
                   | st.dictionaries(st.text(max_size=40) | st.binary(max_size=8), inner,
                                     max_size=20)),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(_values)
def test_nested_values_byte_equal(v):
    _same(v)


# -- the float-run route: lists of floats as one numpy record array ---------------------------


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 65535, 65536, 65537])
def test_float_lists_byte_equal(n):
    """fixarray, array16 and array32 headers around runs of float64 items,
    below and above the fast route's length."""
    xs = np.random.default_rng(n).standard_normal(n).tolist()
    raw = _ref(xs)
    assert packb(xs) == raw
    got = unpackb(raw)
    assert type(got) is list and all(type(v) is float for v in got)
    assert got == msgpack.unpackb(raw, raw=False)
    assert packb(tuple(xs)) == _ref(tuple(xs))


def test_float_runs_keep_special_values():
    specials = [float("nan"), -0.0, 0.0, float("inf"), float("-inf"), 5e-324,
                1.7976931348623157e308]
    xs = specials * 4
    raw = _ref(xs)
    assert packb(xs) == raw
    got = unpackb(raw)
    assert [struct.pack(">d", v) for v in got] == [struct.pack(">d", v) for v in xs]


@pytest.mark.parametrize("xs", [
    [1.5] * 20 + [1],                      # an int among floats
    [1] + [1.5] * 20,
    [1.5] * 20 + [True],                   # bool is not float
    [1.5] * 20 + [None, "x"],
    [1.5] * 10 + [[2.5] * 20] + [3.5] * 10,  # a nested run
    [np.float64(1.5)] * 20,                # a float subclass packs as float64
    [1.5] * 19 + [np.float64(2.5)],
    {"vector": [0.25] * 768, "id": "d1", "n": [1, 2.5, "x"]},
])
def test_mixed_lists_byte_equal(xs):
    _same(xs)


def test_float_run_unpack_checks_every_tag():
    """A run whose items are not all 0xcb floats reads through the slow
    route: a float32 item (0xca) or an int in the middle."""
    for tail in ([msgpack.packb(1.25, use_single_float=True)], [b"\x05"]):
        raw = b"\xdc\x00\x14" + b"".join([_ref(0.5)] * 10 + tail + [_ref(0.5)] * 9)
        assert unpackb(raw) == msgpack.unpackb(raw, raw=False)
    # truncated: the strided view would reach past the end
    raw = _ref([0.5] * 20)[:-1]
    with pytest.raises(ValueError):
        unpackb(raw)


def test_default_hook_as_msgpack():
    v = {"vector": np.arange(20, dtype=np.float32), "ids": [np.arange(3)]}
    want = msgpack.packb(v, use_bin_type=True, default=lambda o: o.tolist())
    assert packb(v, default=lambda o: o.tolist()) == want
    with pytest.raises(TypeError):
        packb(v)
    with pytest.raises(TypeError):
        packb({1, 2}, default=lambda o: o)   # the hook hands back what it refused


def test_msgpack_keywords():
    assert packb([1.5], use_bin_type=True) == _ref([1.5])
    assert unpackb(_ref([1.5]), raw=False) == [1.5]
    with pytest.raises(ValueError):
        packb(b"x", use_bin_type=False)
    with pytest.raises(ValueError):
        unpackb(_ref("x"), raw=True)
