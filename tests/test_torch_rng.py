"""The port's draw-slot RNG == pikazoo_tpu.core.rng, bit for bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pikazoo_tpu.core import rng as jrng
from pikazoo_tpu_torch.core import rng as trng

U32 = 2 ** 32


def _words(rng, shape):
    # Half of the words >= 2^31, where int32 bit patterns are negative.
    return rng.integers(0, U32, shape, dtype=np.uint64).astype(np.uint32)


def _bits(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.view(np.int32).copy())


def test_threefry_known_answer():
    # Random123 KAT: threefry2x32, 20 rounds, zero key and counter.
    r0, r1 = trng.threefry2x32(torch.zeros(2, dtype=torch.int32),
                               torch.tensor(0), 0)
    assert int(r0) == 0x6B200159
    assert int(r1) == 0x99BA4EFE


def test_threefry_matches_jax_package():
    rng = np.random.default_rng(1)
    n = 512
    keys, c0, c1 = _words(rng, (n, 2)), _words(rng, n), _words(rng, n)
    j0, j1 = jax.vmap(jrng.threefry2x32)(jnp.asarray(keys), jnp.asarray(c0),
                                         jnp.asarray(c1))
    t0, t1 = trng.threefry2x32(_bits(keys), _bits(c0), _bits(c1))
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0).astype(np.int64))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))
    assert (keys >= 2 ** 31).any() and (c0 >= 2 ** 31).any()


def test_fold_key_matches_jax_package():
    rng = np.random.default_rng(2)
    for base in (np.zeros(2, np.uint32), np.array([0, 7], np.uint32),
                 _words(rng, 2)):
        want = jax.vmap(jrng.fold_key, in_axes=(None, 0))(
            jnp.asarray(base), jnp.arange(300))
        got = trng.fold_key(_bits(base), torch.arange(300))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want))


@pytest.mark.parametrize("upper", [2, 3, 5, 20])
def test_site_value_matches_jax_package(upper):
    rng = np.random.default_rng(upper)
    n = 400
    keys = _words(rng, (n, 2))
    counters = rng.integers(0, 2 ** 31, n).astype(np.int32)
    want = jax.vmap(jrng.site_value, in_axes=(0, 0, None))(
        jnp.asarray(keys), jnp.asarray(counters), upper)
    got = trng.site_value(_bits(keys), torch.from_numpy(counters), upper)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_draw_masked_counter_matches_jax_package():
    rng = np.random.default_rng(3)
    n = 256
    keys = _words(rng, (n, 2))
    counter = rng.integers(0, 50, n).astype(np.int32)
    jds = jrng.DrawState(key=jnp.asarray(keys), counter=jnp.asarray(counter))
    tds = trng.DrawState(key=_bits(keys), counter=torch.from_numpy(counter))
    for upper in (5, 5, 2, 20, 3):
        consume = rng.integers(0, 2, n).astype(bool)
        jv, jds = jax.vmap(lambda k, c, m: jrng.draw(
            jrng.DrawState(k, c), m, upper))(jds.key, jds.counter,
                                              jnp.asarray(consume))
        jds = jrng.DrawState(*jds[:2])
        tv, tds = trng.draw(tds, torch.from_numpy(consume), upper)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tds.counter.numpy(), np.asarray(jds.counter))


@pytest.mark.parametrize("seed", [0, 7, 12345, 2 ** 31 - 1, -3])
def test_key_data_of_int_seed(seed):
    """An int seed means [0, seed mod 2^32]: jax.random.key(seed)'s key data
    and the JAX package's key_from_jax(seed)."""
    got = trng.key_data(seed).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jrng.key_from_jax(seed)))
    np.testing.assert_array_equal(
        got, np.asarray(jax.random.key_data(jax.random.key(seed))))


def test_key_data_of_words():
    words = np.array([0xDEADBEEF, 0x12345678], np.uint32)
    for form in (words, words.tolist(), torch.from_numpy(words.view(np.int32))):
        np.testing.assert_array_equal(
            trng.key_data(form).numpy().view(np.uint32), words)
    with pytest.raises(ValueError):
        trng.key_data([1, 2, 3])
