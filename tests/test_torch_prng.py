"""The port's threefry PRNG against ``jax.random``: bit-identical keys,
splits, fold-ins and uint32 bits."""
import jax
import numpy as np
import pytest
import torch

from repro_torch.core import prng


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint64)


def _jnp(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint64)


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 2 ** 31 - 1, 123456789])
def test_prngkey(seed):
    np.testing.assert_array_equal(_np(prng.PRNGKey(seed, "cpu")),
                                  _jnp(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [2, 5, 256, (3, 4), (2, 1, 3)])
def test_split(num):
    for seed in (0, 3):
        want = jax.random.split(jax.random.PRNGKey(seed), num)
        got = prng.split(prng.PRNGKey(seed, "cpu"), num)
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_array_equal(_np(got), _jnp(want))


def test_split_chain_and_rows():
    """Iterating split keys row by row, as the protocol does."""
    jk, tk = jax.random.PRNGKey(9), prng.PRNGKey(9, "cpu")
    for _ in range(4):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        np.testing.assert_array_equal(_np(tsub), _jnp(jsub))
    np.testing.assert_array_equal(_np(tk), _jnp(jk))


@pytest.mark.parametrize("data", [0, 1, 99, 2 ** 31, 2 ** 32 - 1])
def test_fold_in(data):
    want = jax.random.fold_in(jax.random.PRNGKey(5), data)
    np.testing.assert_array_equal(_np(prng.fold_in(prng.PRNGKey(5, "cpu"), data)),
                                  _jnp(want))


@pytest.mark.parametrize("shape", [(1,), (7,), (8,), (3, 5, 7), (2, 64, 33)])
def test_bits(shape):
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.bits(key, shape, dtype=np.uint32))
    got = prng.bits(prng.PRNGKey(11, "cpu"), shape)
    np.testing.assert_array_equal(_np(got), want.astype(np.uint64))
    np.testing.assert_array_equal(prng.bits_words(prng.PRNGKey(11, "cpu"), shape).numpy(),
                                  want.view(np.int32))
