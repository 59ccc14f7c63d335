"""The port's reduced-ring nonlinearity lowering (``nn/approx``) against the
reference's (mirrors tests/test_nn_approx.py): PWL specs equal, the
closed form and the hook path, the fixed-point bounds, and the MPC
evaluations (``apply_pwl_mpc``, ``relu_attention_mpc``) share for share
at (k, m) = (64, 0) and (21, 13)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comm as jcomm, mpc_tensor as jmt, ring as jring
from repro.core.hummingbird import HBLayer as JHBLayer
from repro.nn import approx as japprox
from repro.nn.approx.pwl import _gelu, _silu
from repro_torch.core import comm as tcomm, mpc_tensor as tmt, prng, ring as tring
from repro_torch.core.hummingbird import HBLayer
from repro_torch.nn import approx

FNS = {"silu": _silu, "gelu": _gelu}


def _spec(mod, act):
    return mod.silu_spec() if act == "silu" else mod.gelu_spec()


def _jrelu_fn(k, m, comm, seed=7):
    """The reference's hook harness: one relu_many per relu call, one fused
    products_many per matmul/mul, keys in call order."""
    keys = iter(jax.random.split(jax.random.PRNGKey(seed), 512))
    hb = JHBLayer(k=k, m=m)

    def relu_fn(ts, group):
        return jmt.relu_many([next(keys) for _ in ts], ts, comm=comm, hbs=[hb] * len(ts))

    relu_fn.matmul = lambda xs, ys: jmt.products_many(
        ["matmul"] * len(xs), [next(keys) for _ in xs], xs, ys, comm=comm)
    relu_fn.mul = lambda xs, ys: jmt.products_many(
        ["mul"] * len(xs), [next(keys) for _ in xs], xs, ys, comm=comm)
    return relu_fn


def _trelu_fn(k, m, comm, seed=7):
    """The same harness over the port."""
    keys = iter(prng.split(prng.PRNGKey(seed, "cpu"), 512))
    hb = HBLayer(k=k, m=m)

    def relu_fn(ts, group):
        return tmt.relu_many([next(keys) for _ in ts], ts, comm=comm, hbs=[hb] * len(ts))

    relu_fn.matmul = lambda xs, ys: tmt.products_many(
        ["matmul"] * len(xs), [next(keys) for _ in xs], xs, ys, comm=comm)
    relu_fn.mul = lambda xs, ys: tmt.products_many(
        ["mul"] * len(xs), [next(keys) for _ in xs], xs, ys, comm=comm)
    return relu_fn


def _pair(seed: int, x: np.ndarray):
    return (jmt.MPCTensor.from_plain(jax.random.PRNGKey(seed), jnp.asarray(x)),
            tmt.MPCTensor.from_plain(prng.PRNGKey(seed, "cpu"), torch.from_numpy(x)))


def _same(j, t):
    np.testing.assert_array_equal(tring.to_uint64_np(t.data), jring.to_uint64_np(j.data))


# ---------------------------------------------------------------------------
# Plaintext closed form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_specs_equal_the_reference(act):
    got, want = _spec(approx, act), _spec(japprox, act)
    assert (got.name, got.knots, got.coeffs, got.c0) == \
        (want.name, want.knots, want.coeffs, want.c0)
    assert approx.spec_for(act) == _spec(approx, act)
    assert approx.pwl_max_error(got, FNS[act]) == japprox.pwl_max_error(want, FNS[act])
    assert approx.pwl_fixed_point_bound(got) == japprox.pwl_fixed_point_bound(want)


def test_spec_for_resolution_and_bounds():
    assert approx.spec_for("relu") is None
    with pytest.raises(ValueError):
        approx.spec_for("swiglu2")
    for m in (0, 6, 13):
        assert approx.discard_margin(m) == japprox.discard_margin(m)
    assert approx.magnitude_bound(22) == japprox.magnitude_bound(22) == 32.0
    with pytest.raises(ValueError):
        approx.discard_margin(-1)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_eval_pwl_and_hook_path(act, rng):
    spec = _spec(approx, act)
    x = rng.uniform(-10, 10, (4, 17)).astype(np.float32)
    got = approx.eval_pwl(spec, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(japprox.eval_pwl(_spec(japprox, act),
                                                                   jnp.asarray(x))))
    hooked = approx.apply_pwl(spec, torch.from_numpy(x), 0, approx.ensure_hooks(None))
    np.testing.assert_allclose(hooked.numpy(), got, atol=1e-5)


def test_causal_norm_and_plaintext_attention(rng):
    np.testing.assert_array_equal(approx.causal_norm(5).numpy(),
                                  np.asarray(japprox.causal_norm(5)))
    q, k, v = (rng.uniform(-1, 1, (1, 2, 6, 8)).astype(np.float32) for _ in range(3))
    got = approx.relu_attention(*(torch.from_numpy(a) for a in (q, k, v)), 0,
                                approx.ensure_hooks(None)).numpy()
    want = np.asarray(japprox.relu_attention(*(jnp.asarray(a) for a in (q, k, v)), 0,
                                             japprox.ensure_hooks(None)))
    np.testing.assert_allclose(got, want, atol=1e-6)


# ---------------------------------------------------------------------------
# MPC evaluations, share for share
# ---------------------------------------------------------------------------

KM = [(64, 0), (21, 13)]


@pytest.mark.parametrize("k,m", KM)
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_apply_pwl_mpc_bit_identical(act, k, m):
    x = np.random.default_rng(3).uniform(-6, 6, (2, 48)).astype(np.float32)
    jx, tx = _pair(1, x)
    jcc, tcc = jcomm.CoalescingComm(), tcomm.CoalescingComm()
    (jout,) = japprox.apply_pwl_mpc(_spec(japprox, act), [jx], 0, _jrelu_fn(k, m, jcc))
    (tout,) = approx.apply_pwl_mpc(_spec(approx, act), [tx], 0, _trelu_fn(k, m, tcc))
    _same(jout, tout)
    assert (tcc.n_rounds, tcc.bytes_tx) == (jcc.n_rounds, jcc.bytes_tx)
    if m == 0:
        ref = approx.eval_pwl(_spec(approx, act), torch.from_numpy(tx.reveal_np())).numpy()
        np.testing.assert_allclose(tout.reveal_np(), ref, atol=5e-3)


@pytest.mark.parametrize("k,m", KM)
def test_relu_attention_mpc_bit_identical(k, m):
    """Two sibling streams: each matmul's two opens coalesce into one
    round, the ReLU on both streams' scores runs in one relu_many."""
    rng = np.random.default_rng(4)
    qkv = [[rng.uniform(-1, 1, (1, 2, 6, 8)).astype(np.float32) for _ in range(3)]
           for _ in range(2)]
    pairs = [[_pair(10 * s + i, a) for i, a in enumerate(t)] for s, t in enumerate(qkv)]
    jcc, tcc = jcomm.CoalescingComm(), tcomm.CoalescingComm()
    jouts = japprox.relu_attention_mpc(*([p[i][0] for p in pairs] for i in range(3)), 0,
                                       _jrelu_fn(k, m, jcc))
    touts = approx.relu_attention_mpc(*([p[i][1] for p in pairs] for i in range(3)), 0,
                                      _trelu_fn(k, m, tcc))
    for j, t in zip(jouts, touts):
        _same(j, t)
    assert (tcc.n_rounds, tcc.bytes_tx, tcc.round_parts) == \
        (jcc.n_rounds, jcc.bytes_tx, jcc.round_parts)
    if m == 0:
        for t, (q, kk, v) in zip(touts, qkv):
            ref = approx.relu_attention(*(torch.from_numpy(a) for a in (q, kk, v)), 0,
                                        approx.ensure_hooks(None)).numpy()
            np.testing.assert_allclose(t.reveal_np(), ref, atol=2e-2)
