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


@pytest.mark.parametrize("chunk", [1, 7, 64, 1000])
def test_bits_in_chunks_of_the_counter(chunk, monkeypatch):
    """A draw longer than its device's ``BITS_CHUNK`` is hashed chunk by
    chunk of the flat counter: the same words, ragged last chunk included."""
    monkeypatch.setitem(prng.BITS_CHUNK, "cpu", chunk)
    shape = (3, 5, 67)
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(11), shape, dtype=np.uint32))
    got = prng.bits(prng.PRNGKey(11, "cpu"), shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_np(got), want.astype(np.uint64))
    np.testing.assert_array_equal(prng.bits_words(prng.PRNGKey(11, "cpu"), shape).numpy(),
                                  want.view(np.int32))


@pytest.mark.parametrize("shape", [(7,), (3, 5, 7), (4096,)])
@pytest.mark.parametrize("lo_hi", [(0.0, 1.0), (-2.5, 4.0), (-1.3, 0.7)])
def test_uniform_floats(shape, lo_hi):
    """``jax.random.uniform`` float32 bit for bit, with the scale and shift
    XLA fuses into one fma."""
    lo, hi = lo_hi
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), shape, minval=lo,
                                         maxval=hi))
    got = prng.uniform(prng.PRNGKey(3, "cpu"), shape, lo, hi)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n", [0, 1, 2, 10, 384, 1625, 1626, 2000, 4096])
def test_permutation(n):
    """``jax.random.permutation(key, n)`` exactly: one sort round up to 1625,
    two above."""
    for seed in (0, 5):
        want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
        got = prng.permutation(prng.PRNGKey(seed, "cpu"), n)
        np.testing.assert_array_equal(got.numpy(), want)


def test_normal_on_tolerance():
    """``jax.random.normal``: the same uniform draw, then torch's erfinv
    against XLA's polynomial: within 2e-5 absolute and 1e-5 relative over
    a million draws (|x| up to about 5)."""
    shape = (1000, 3, 16, 16)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(2), shape))
    got = prng.normal(prng.PRNGKey(2, "cpu"), shape).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
