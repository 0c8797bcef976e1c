"""The port's ``split``, ``fold_in`` and ``randint`` == ``jax.random``'s on
threefry keys, bit for bit (this JAX runs ``jax_threefry_partitionable``)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pikazoo_tpu_torch.core import rng

SEEDS = [0, 1, 2026, 2 ** 31 + 5, 2 ** 32 - 1]


def jax_words(keys) -> np.ndarray:
    return np.asarray(jax.random.key_data(keys)).view(np.int32)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 3, 16])
def test_split_matches_jax(seed, n):
    got = rng.split(rng.key_data(seed), n).numpy()
    np.testing.assert_array_equal(got, jax_words(jax.random.split(jax.random.key(seed), n)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_matches_jax(seed):
    key = rng.key_data(seed)
    for data in (0, 1, 2, 7, 2 ** 31 + 3, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            rng.fold_in(key, data).numpy(),
            jax_words(jax.random.fold_in(jax.random.key(seed), data)), err_msg=str(data))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi,shape", [
    (0, 18, ()), (0, 13, (7,)), (-5, 100_000, (3, 4)), (3, 3, (2,)), (7, 2, (4,)),
    (-2 ** 31, 2 ** 31 - 1, (50,)), (0, 2 ** 20 + 7, (33,))])
def test_randint_matches_jax(seed, lo, hi, shape):
    """Spans above 2^16 wrap the uint32 multiplier; hi <= lo gives lo."""
    got = rng.randint(rng.key_data(seed), shape, lo, hi).numpy()
    want = np.asarray(jax.random.randint(jax.random.key(seed), shape, lo, hi, jnp.int32))
    np.testing.assert_array_equal(got, want)


def test_batched_keys_match_vmapped_jax():
    """A batch of keys (one an env, as the wrappers hold them) against
    ``vmap`` over raw key data, the way the JAX wrappers call these."""
    keys = rng.split(rng.key_data(9), 64)
    raw = jnp.asarray(keys.numpy().view(np.uint32))
    np.testing.assert_array_equal(
        rng.split(keys).numpy(), np.asarray(jax.vmap(jax.random.split)(raw)).view(np.int32))
    np.testing.assert_array_equal(
        rng.randint(keys, (), 0, 18).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), 0, 18, jnp.int32))(raw)))
    np.testing.assert_array_equal(
        rng.fold_in(keys, 5).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, 5))(raw)).view(np.int32))
