"""The port's numpy copy of JAX's random stream against ``jax.random``.

The device embedder's projection must be JAX's bit for bit, or a store
embedded by the JAX package and queried through the port would live in
another vector space. Every comparison here is exact: bf16 planes through
their uint16 views, threefry words and bytes as integers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grape_vector_db_tpu_torch.utils import jax_random


def _bits16(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def _jax_normal(seed, shape) -> np.ndarray:
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                        jnp.bfloat16)).view(np.uint16)


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1])
def test_projection_bit_equal_at_the_embedder_shape(seed):
    """The default embedder's plane, [32768, 768]."""
    got = jax_random.normal_bf16(seed, (32768, 768))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (32768, 768)
    np.testing.assert_array_equal(_bits16(got), _jax_normal(seed, (32768, 768)))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (1025, 3), (2, 3, 4), (4096, 96)])
@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_normal_bit_equal_at_small_and_odd_shapes(shape, seed):
    np.testing.assert_array_equal(_bits16(jax_random.normal_bf16(seed, shape)),
                                  _jax_normal(seed, shape))


@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1, -1, 2**32 + 5])
def test_key_matches_prngkey(seed):
    np.testing.assert_array_equal(jax_random.prng_key(seed),
                                  np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))))


@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
def test_random_bytes_match_jax_bits(seed):
    shape = (37, 41)
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint8)).ravel()
    got = jax_random.random_bits8(jax_random.prng_key(seed), np.arange(37 * 41))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 9])
def test_threefry_words_match_jax(seed):
    """The raw 32-bit words: ``jax.random.bits`` at uint32 is bits1 ^ bits2."""
    shape = (64, 33)
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32)).ravel()
    i = np.arange(64 * 33, dtype=np.uint64)
    b1, b2 = jax_random.threefry2x32(jax_random.prng_key(seed), (i >> np.uint64(32)).astype(
        np.uint32), i.astype(np.uint32))
    assert b1.dtype == b2.dtype == np.uint32
    np.testing.assert_array_equal(b1 ^ b2, want)


def test_threefry_known_answer():
    """The Threefry-2x32 test vector of Salmon et al. (Random123), as JAX's
    own tests use it: key (0x13198a2e, 0x03707344), counter (0x243f6a88,
    0x85a308d3)."""
    key = np.array([0x13198A2E, 0x03707344], np.uint32)
    b1, b2 = jax_random.threefry2x32(key, np.array([0x243F6A88], np.uint32),
                                     np.array([0x85A308D3], np.uint32))
    assert (int(b1[0]), int(b2[0])) == (0xC4923A9C, 0x483DF7A0)


def test_table_covers_every_byte():
    """Each element is a function of its byte >> 1: the 128 table values are
    what JAX gives for those bytes."""
    key = jax.random.PRNGKey(0)
    shape = (4096, 64)
    byte = np.asarray(jax.random.bits(key, shape, jnp.uint8)).ravel() >> 1
    vals = np.asarray(jax.random.normal(key, shape, jnp.bfloat16)).view(np.uint16).ravel()
    table = _bits16(jax_random.normal_bf16_table())
    assert len(np.unique(byte)) == 128
    np.testing.assert_array_equal(table[byte], vals)
