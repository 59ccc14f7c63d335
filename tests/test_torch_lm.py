"""The port's private LM inference against the reference's (mirrors
tests/test_lm_mpc.py), on the CPU at the smoke width (d_model 64, 4 heads,
d_ff 128, SEQ 4):

- the architecture registry resolves as the reference's, the LM's MPC
  forward by config type, and a non-dense family is rejected;
- the traced plan (2 ReLU groups and 3 Beaver opens per gated layer) has
  the reference's JSON and digest byte for byte, validates, and survives
  a JSON round trip;
- one block through ``compile(...)`` gives shares bit-identical to the
  reference's, counters equal to ``plan.schedule()``, a reveal within
  1e-2 of the plaintext twin; the per-site reduced plan too, with fewer
  rounds; ``scan`` and ``python`` give the same shares;
- two layers over two sibling streams (groups 2l / 2l+1, each open
  coalescing both streams) bit-identical, exact and reduced.

The reference's run of each configuration is computed once per module.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro import api as japi, configs as jconfigs
from repro.core import comm as jcomm, ring as jring
from repro.core.hummingbird import HBConfig as JHBConfig, HBLayer as JHBLayer
from repro.models import lm as jlm
from repro_torch import api as tapi, configs as tconfigs, errors as terrors
from repro_torch.core import comm as tcomm, prng, ring as tring
from repro_torch.core.hummingbird import HBConfig, HBLayer
from repro_torch.models import lm as tlm

SEQ = 4


def _cfgs(n_layers: int):
    base = "qwen1.5-0.5b-smoke"
    return (dataclasses.replace(jconfigs.get(base), n_layers=n_layers),
            dataclasses.replace(tconfigs.get(base), n_layers=n_layers))


def _reduced_layers(n_groups: int):
    """The reference test's per-site choice: (22, 0) on the score groups,
    (22, 6) on the PWL groups."""
    return [(22, 0) if g % 2 == 0 else (22, 6) for g in range(n_groups)]


def _jplan(plan, kms):
    return plan if kms is None else plan.with_hb(JHBConfig(
        tuple(JHBLayer(k=k, m=m) for k, m in kms), plan.hb.group_elements))


def _tplan(plan, kms):
    return plan if kms is None else plan.with_hb(HBConfig(
        tuple(HBLayer(k=k, m=m) for k, m in kms), plan.group_elements))


class _Setup:
    """One configuration in both packages: weights (the reference's, carried
    across), hidden states per stream, traced plans."""

    def __init__(self, n_layers: int, streams: int, seq: int = SEQ):
        self.jcfg, self.tcfg = _cfgs(n_layers)
        self.params = jlm.init(jax.random.PRNGKey(0), self.jcfg)
        self.tparams = tlm.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                  self.params), "cpu")
        self.hs = [np.asarray(jax.random.normal(jax.random.PRNGKey(1 + 10 * i),
                                                (1, seq, self.jcfg.d_model))) * 0.5
                   for i in range(streams)]
        self.jplan = jlm.trace(self.params, self.jcfg, 1, seq)
        self.tplan = tlm.trace(self.tparams, self.tcfg, 1, seq)
        self._runs = {}

    def ref_run(self, kms):
        """The reference's compile(...) over every stream: output shares (as
        uint64) and the counting comm's rounds and bytes."""
        key = tuple(kms) if kms is not None else None
        if key not in self._runs:
            cfg = self.jcfg
            cc = jcomm.CoalescingComm(jcomm.CountingComm())
            model = japi.compile(lambda p, x, relu_fn=None: jlm.mpc_reference(
                p, x, cfg, relu_fn=relu_fn), self.params, cfg,
                _jplan(self.jplan, kms), japi.Session(key=0, comm=cc))
            xs = [model.encrypt(jax.random.PRNGKey(2 + i), h)
                  for i, h in enumerate(self.hs)]
            outs = model(xs, key=jax.random.PRNGKey(3))
            self._runs[key] = ([jring.to_uint64_np(x.data) for x in xs],
                               [jring.to_uint64_np(o.data) for o in outs],
                               cc.n_rounds, cc.bytes_tx)
        return self._runs[key]

    def port_run(self, kms, comm=None):
        """The port's compile(...) on the same inputs: input shares, outputs,
        the model."""
        model = tapi.compile(None, self.tparams, self.tcfg, _tplan(self.tplan, kms),
                             tapi.Session(key=0, comm=comm, device="cpu"))
        xs = [model.encrypt(prng.PRNGKey(2 + i, "cpu"), h)
              for i, h in enumerate(self.hs)]
        return xs, model(xs, key=prng.PRNGKey(3, "cpu")), model

    def plaintext(self, i: int) -> np.ndarray:
        return tlm.mpc_reference(self.tparams, torch.from_numpy(self.hs[i]),
                                 self.tcfg).numpy()


@pytest.fixture(scope="module")
def one_block():
    return _Setup(n_layers=1, streams=1)


@pytest.fixture(scope="module")
def two_layers():
    return _Setup(n_layers=2, streams=2)


# ---------------------------------------------------------------------------
# Registry, registration, init
# ---------------------------------------------------------------------------

def test_registry_resolves_as_the_reference():
    assert tconfigs.all_names() == jconfigs.all_names()
    for name in jconfigs.all_names():
        for n in (name, name + "-smoke"):
            assert dataclasses.asdict(tconfigs.get(n)) == \
                dataclasses.asdict(jconfigs.get(n))
    full = tconfigs.get("qwen1.5-0.5b")
    assert (full.family, full.n_layers, full.d_model, full.n_heads, full.d_ff,
            full.vocab, full.qkv_bias) == ("dense", 24, 1024, 16, 2816, 151936, True)
    smoke = tconfigs.get("qwen1.5-0.5b-smoke")
    assert tapi.resolve_mpc_forward(smoke) is tlm._lm_mpc_forward
    assert tapi.resolve_mpc_forward(tconfigs.RESNET_SMOKE) is not tlm._lm_mpc_forward


def test_non_dense_family_rejected(one_block):
    """The MPC lowering refuses a non-dense family, as the reference's;
    ``init`` builds that family's tree in the reference's layout."""
    moe = dataclasses.replace(one_block.tcfg, family="moe", n_experts=4, top_k=2)
    with pytest.raises(ValueError, match="dense"):
        tlm.mpc_reference(one_block.tparams, torch.zeros((1, SEQ, 64)), moe)
    got = tlm.init(moe, torch.Generator().manual_seed(0))
    want = jax.eval_shape(lambda k: jlm.init(k, dataclasses.replace(
        one_block.jcfg, family="moe", n_experts=4, top_k=2)), jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert (tuple(g.shape), str(g.dtype).split(".")[-1]) == (w.shape, w.dtype.name)
    assert got["layers"]["moe"]["w_up"].shape == (1, 4, 64, 128)


def test_init_tree_matches_the_reference_layout(one_block):
    """``init`` from a torch.Generator: the reference's keys, shapes and
    dtypes (layers stacked on axis 0), its init scales, and a different
    seed gives different weights."""
    got = tlm.init(one_block.tcfg, torch.Generator().manual_seed(0))
    want = jax.tree_util.tree_map(np.asarray, one_block.params)

    def walk(g, w, path=()):
        assert isinstance(g, dict) == isinstance(w, dict), path
        if isinstance(w, dict):
            assert sorted(g) == sorted(w), path
            for k in w:
                walk(g[k], w[k], path + (k,))
        else:
            assert tuple(g.shape) == w.shape and str(g.dtype) == f"torch.{w.dtype}", path

    walk(got, want)
    assert torch.equal(got["layers"]["attn"]["wq"]["b"], torch.zeros((1, 64)))
    assert abs(float(got["lm_head"]["w"].std()) - 64 ** -0.5) < 0.01
    other = tlm.init(one_block.tcfg, torch.Generator().manual_seed(1))
    assert not torch.equal(other["lm_head"]["w"], got["lm_head"]["w"])


# ---------------------------------------------------------------------------
# Plan structure
# ---------------------------------------------------------------------------

def test_plan_json_digest_and_roundtrip(one_block, tmp_path):
    cfg, plan = one_block.tcfg, one_block.tplan
    assert len(plan.calls) == 2 * cfg.n_layers
    assert [o.label for o in plan.opens] == ["matmul", "matmul", "mul"]
    assert plan.to_json() == one_block.jplan.to_json()
    assert json.dumps(plan.to_json(), sort_keys=True) == \
        json.dumps(one_block.jplan.to_json(), sort_keys=True)
    assert plan.digest() == one_block.jplan.digest()
    plan.validate()
    path = tmp_path / "lm_plan.json"
    plan.save(path)
    back = tapi.Plan.load(path)
    assert back == plan and back.digest() == plan.digest()
    assert back.open_specs() == plan.open_specs() == one_block.jplan.open_specs()
    for streams in (1, 2):
        got, want = back.schedule(streams), one_block.jplan.schedule(streams)
        assert (got.n_rounds, got.bytes_tx) == (want.n_rounds, want.bytes_tx)


def test_plan_validate_rejects_bad_opens(one_block):
    plan = one_block.tplan
    for bad in (tapi.OpenCall(-1, 0, "mul"), tapi.OpenCall(8, 3, "mul")):
        with pytest.raises(terrors.PlanInvalid, match="open"):
            dataclasses.replace(plan, opens=plan.opens + (bad,)).validate()


@pytest.mark.parametrize("s", [64, 128, 512])
@pytest.mark.parametrize("dh", [16, 64])
def test_rope_tables_encode_as_the_reference(s, dh):
    """The port's own RoPE tables (``nn/rope_tables.py``, which
    ``_rope_mpc`` reads) against the reference's float32 expressions
    (``models/lm.py`` ``_rope_mpc``) at the smoke head (16) and the full
    width's (64), past the lengths where float32 torch math part ways:
    the same float32 bits, so the same encoded tables."""
    import jax.numpy as jnp

    from repro.core import mpc_tensor as jmt
    from repro_torch.core import mpc_tensor as tmt
    from repro_torch.nn import rope_tables

    half = dh // 2
    for theta in (10000.0, 1e6):
        freqs = theta ** (-jnp.arange(0, half, dtype=jnp.float32) / half)
        ang = jnp.arange(s, dtype=jnp.float32)[:, None] * freqs
        got = rope_tables.rope_tables(s, dh, theta, "cpu")
        for jf, t in zip((jnp.cos, jnp.sin), got):
            want = np.asarray(jf(ang))[:, None, :]
            assert t.dtype == torch.float32 and tuple(t.shape) == want.shape
            np.testing.assert_array_equal(t.numpy().view(np.int32), want.view(np.int32))
            np.testing.assert_array_equal(
                tmt.encode_weights(t, device="cpu").numpy(),
                np.asarray(jmt.encode_weights(jnp.asarray(want))))


def test_sincos_f32_equals_xla_over_the_float_range():
    """``sincos_f32`` against XLA's float32 cos/sin on the CPU, bit for bit,
    on both reductions (below and above 120), negative arguments, the
    polynomial-only range below pi/4 and the tiny range below 2^-12."""
    import jax.numpy as jnp

    from repro_torch.nn.rope_tables import sincos_f32

    rng = np.random.default_rng(7)
    x = np.concatenate([rng.uniform(-1e4, 1e4, 40000), rng.uniform(-120, 120, 40000),
                        rng.uniform(-1, 1, 20000), rng.uniform(-1e-3, 1e-3, 5000),
                        rng.uniform(-3e7, 3e7, 20000),
                        [0.0, -0.0, 119.99999, 120.0, 2 ** -12, np.pi / 4]]
                       ).astype(np.float32)
    for jf, cos in ((jnp.cos, True), (jnp.sin, False)):
        np.testing.assert_array_equal(
            sincos_f32(torch.from_numpy(x), cos).numpy().view(np.int32),
            np.asarray(jf(jnp.asarray(x))).view(np.int32))


# ---------------------------------------------------------------------------
# One block: bit identity, counters, closeness
# ---------------------------------------------------------------------------

def test_one_block_compile_bit_identical_and_counts(one_block):
    ref_in, ref_out, ref_rounds, ref_bytes = one_block.ref_run(None)
    cc = tcomm.CoalescingComm(tcomm.CountingComm())
    xs, outs, _ = one_block.port_run(None, cc)
    np.testing.assert_array_equal(tring.to_uint64_np(xs[0].data), ref_in[0])
    np.testing.assert_array_equal(tring.to_uint64_np(outs[0].data), ref_out[0])
    sched = one_block.tplan.schedule()
    assert (cc.n_rounds, cc.bytes_tx) == (sched.n_rounds, sched.bytes_tx) == \
        (ref_rounds, ref_bytes)
    assert (cc.base.n_swaps, cc.base.bytes_tx) == (sched.n_rounds, sched.bytes_tx)
    err = np.max(np.abs(outs[0].reveal_np() - one_block.plaintext(0)))
    assert err < 1e-2, err


def test_one_block_reduced_plan_bit_identical(one_block):
    kms = _reduced_layers(one_block.tplan.n_groups)
    _, ref_out, ref_rounds, ref_bytes = one_block.ref_run(kms)
    cc = tcomm.CoalescingComm()
    _, outs, _ = one_block.port_run(kms, cc)
    np.testing.assert_array_equal(tring.to_uint64_np(outs[0].data), ref_out[0])
    plan = _tplan(one_block.tplan, kms)
    assert plan.hb.budget_fraction() < 1.0
    assert (cc.n_rounds, cc.bytes_tx) == (ref_rounds, ref_bytes) == \
        (plan.schedule().n_rounds, plan.schedule().bytes_tx)
    assert plan.schedule().n_rounds < one_block.tplan.schedule().n_rounds
    err = np.max(np.abs(outs[0].reveal_np() - one_block.plaintext(0)))
    assert err < 0.15, err


def test_one_block_scan_equals_python(one_block, monkeypatch):
    """A plan with opens stays on the generator loop under ``scan``: the
    same shares as ``python`` (and the reference's), and nothing captured."""
    _, ref_out, _, _ = one_block.ref_run(None)
    got = {}
    for mode in ("python", "scan"):
        monkeypatch.setenv("HB_ROUND_LOOP", mode)
        xs, outs, model = one_block.port_run(None, tcomm.CoalescingComm())
        got[mode] = tring.to_uint64_np(outs[0].data)
        assert model.replay_stats(xs) is None
    np.testing.assert_array_equal(got["scan"], got["python"])
    np.testing.assert_array_equal(got["scan"], ref_out[0])


# ---------------------------------------------------------------------------
# Two layers, two sibling streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True], ids=["exact", "reduced"])
def test_two_layers_two_streams_bit_identical(two_layers, reduced):
    """Groups 2l (scores) and 2l+1 (PWL) of both layers, each product
    site's two streams coalesced into one open round: shares equal the
    reference's per stream, counters equal ``plan.schedule(streams=2)``."""
    plan = two_layers.tplan
    assert [c.group for c in plan.calls] == [0, 1, 2, 3]
    assert [o.at_call for o in plan.opens] == [0, 1, 2, 2, 3, 4]
    kms = _reduced_layers(plan.n_groups) if reduced else None
    _, ref_out, ref_rounds, ref_bytes = two_layers.ref_run(kms)
    cc = tcomm.CoalescingComm()
    _, outs, _ = two_layers.port_run(kms, cc)
    for got, want in zip(outs, ref_out):
        np.testing.assert_array_equal(tring.to_uint64_np(got.data), want)
    sched = _tplan(plan, kms).schedule(streams=2)
    assert (cc.n_rounds, cc.bytes_tx) == (sched.n_rounds, sched.bytes_tx) == \
        (ref_rounds, ref_bytes)
    # every open round carries both streams' payloads
    # (the ReLU rounds' two streams auto-batch into one payload)
    assert cc.round_parts.count(2) == len(plan.opens)
    if not reduced:
        for i, out in enumerate(outs):
            assert np.max(np.abs(out.reveal_np() - two_layers.plaintext(i))) < 1e-2


def test_bench_lm_entry_reproduced():
    """The reference benchmark's ``lm`` entry (``BENCH_relu.json``: the
    smoke block at seq 8) through the port on the CPU, on the reference's
    weights, inputs and keys: the same fused rounds and bytes, and the
    error against the plaintext twin within the entry's.  (The reference
    itself gives 1.1216e-3 here with jax 0.9, below the entry's 1.48e-3;
    the port's shares equal the reference's, as the tests above hold.)"""
    from pathlib import Path

    entry = json.loads((Path(__file__).resolve().parents[1] / "BENCH_relu.json")
                       .read_text())["lm"]
    jcfg, tcfg = _cfgs(entry["n_layers"])
    seq = entry["seq"]
    params = jlm.init(jax.random.PRNGKey(0), jcfg)
    tparams = tlm.params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    h = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, seq, jcfg.d_model))) * 0.5
    plan = tlm.trace(tparams, tcfg, 1, seq)
    assert (len(plan.calls), len(plan.opens)) == (entry["n_relu_calls"], entry["n_opens"])
    cc = tcomm.CoalescingComm(tcomm.CountingComm())
    model = tapi.compile(None, tparams, tcfg, plan, tapi.Session(key=0, comm=cc, device="cpu"))
    out = model(model.encrypt(prng.PRNGKey(2, "cpu"), h), key=prng.PRNGKey(3, "cpu"))
    assert (cc.n_rounds, cc.bytes_tx) == (entry["fused_rounds"], entry["bytes_fused"]) == \
        (plan.schedule().n_rounds, plan.schedule().bytes_tx)
    err = np.max(np.abs(out.reveal_np() - tlm.mpc_reference(
        tparams, torch.from_numpy(h), tcfg).numpy()))
    assert err <= entry["max_abs_err_vs_plaintext"], err
