"""The paper's Theorem 1 and Theorem 2 as properties of the port's GMW
ReLU (``repro_torch.core.gmw.relu`` on the CPU, ``SimComm``), mirroring
tests/test_theorems.py: hypothesis draws (``max_examples=10``), each
padded with zeros to 32 elements so every run has one shape, plus one
fixed draw per theorem held bit for bit against the reference's
``_relu_protocol``; the underflow edge, ``safe_k`` and ``n_rounds``."""
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="hypothesis not installed (see requirements-dev.txt)")
from hypothesis import given, settings, strategies as st

from repro_torch.core import beaver, comm as comm_lib, fixed, gmw, prng, shares
from repro_torch.core.hummingbird import safe_k
from test_theorems import _relu_protocol as ref_relu_protocol

E = 32          # every draw is padded to this many elements


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pad(vals) -> np.ndarray:
    x = np.zeros(E, np.float32)
    x[:len(vals)] = vals
    return x


def _relu_protocol(x_f: np.ndarray, k: int, m: int, seed: int = 0) -> np.ndarray:
    """The reference's ``_relu_protocol`` on the port: share, one triple
    bundle and one key from ``seed``, ``gmw.relu``, reconstruct, decode."""
    n = x_f.shape[0]
    X = shares.share(prng.PRNGKey(seed, "cpu"), fixed.encode_np(x_f, device="cpu"))
    tr = beaver.gen_relu_triples(prng.PRNGKey(seed + 1, "cpu"), n, k - m)
    R = gmw.relu(prng.PRNGKey(seed + 2, "cpu"), X, tr, comm_lib.SimComm(), k=k, m=m)
    return fixed.decode_np(shares.reconstruct(R))


_FLOATS = st.lists(st.floats(min_value=-7.875, max_value=7.875, allow_nan=False,
                             width=32), min_size=4, max_size=E)


def _theorem1(x, seed):
    """|x| < 2^(k-1-16)  =>  reduced-ring ReLU == exact ReLU."""
    got = _relu_protocol(x, k=20, m=0, seed=seed)   # k = 20 covers |x| < 8
    np.testing.assert_allclose(got, np.maximum(x, 0), atol=1e-4)
    return got


def _theorem2(x, m, seed):
    """Dropping m low bits == magnitude pruning below 2^(m-16), with the
    documented +-1-LSB boundary band from the floor(x/2^m)-1 case."""
    k = safe_k(int(np.ceil(np.max(np.abs(x)) * 2 ** 16)) + 1, m=m)
    got = _relu_protocol(x, k=k, m=m, seed=seed)
    exact = np.maximum(x, 0.0)
    pruned = np.where((x > 0) & (x < 2.0 ** (m - 16)), 0.0, exact)
    ok = (np.abs(got - exact) < 1e-3) | (np.abs(got - pruned) < 1e-3)
    assert ok.all(), (x[~ok], got[~ok], m)
    return got, k


@settings(max_examples=10, deadline=None)
@given(_FLOATS, st.integers(min_value=0, max_value=3))
def test_theorem1_high_bit_drop_exact(vals, seed):
    _theorem1(_pad(vals), seed)


@settings(max_examples=10, deadline=None)
@given(_FLOATS, st.integers(min_value=8, max_value=14),
       st.integers(min_value=0, max_value=3))
def test_theorem2_low_bit_drop_is_pruning(vals, m, seed):
    _theorem2(_pad(vals), m, seed)


# one fixed draw per theorem, bit for bit against the reference
_PINNED = _pad([-7.5, -3.25, -0.001, 0.0, 0.0002, 0.0031, 0.5, 1.75, 7.8, -6.0,
                2.0 ** -14, -(2.0 ** -14), 3.999, -0.0625])


def test_theorem1_pinned_draw_equals_reference():
    got = _theorem1(_PINNED, seed=1)
    np.testing.assert_array_equal(got, ref_relu_protocol(_PINNED, k=20, m=0, seed=1))


def test_theorem2_pinned_draw_equals_reference():
    got, k = _theorem2(_PINNED, m=12, seed=2)
    np.testing.assert_array_equal(got, ref_relu_protocol(_PINNED, k=k, m=12, seed=2))


def test_theorem2_underflow_edge():
    """x at the negative edge of the reduced range with m > 0 flips sign
    (the proof's case (2)); one margin bit restores correctness."""
    x = _pad([-7.997, -7.94])                        # |x_int| ~ 2^19
    m = 14
    got_tight = _relu_protocol(x, k=20, m=m)         # range edge: flips to +
    assert (got_tight != 0).any()                    # sign error observable
    got_margin = _relu_protocol(x, k=21, m=m)        # one headroom bit
    np.testing.assert_allclose(got_margin, 0.0, atol=1e-4)


def test_safe_k_accounts_for_truncation_headroom():
    assert safe_k(2 ** 19 - 1, m=0) == 20
    assert safe_k(2 ** 19 - 1, m=14) == 21  # +2^m pushes past 2^19


def test_rounds_match_formula():
    """gmw.n_rounds: prep + (1 + ceil(log2 w)) circuit + b2a + mult."""
    assert gmw.n_rounds(64) == 10
    assert gmw.n_rounds(8) == 7
    assert gmw.n_rounds(6) == 7
    assert gmw.n_rounds(4) == 6
    # paper Fig. 11: 1.12-1.56x round reduction; w=64 -> w=6 gives 1.43x
    assert 1.12 <= gmw.n_rounds(64) / gmw.n_rounds(6) <= 1.56
