"""The port's round-loop backends (``repro_torch/runtime/loop.py``) and
``PrivateModel``'s whole-call replay, mirroring the reference's
``tests/test_compiled_loop.py`` (backend selection, eligibility, scan vs
python on a tiny 2-group MLP, the shared replay cache, the ineligible comm)
and holding the port's ``scan`` against the reference bit for bit.  On the
CPU the replay is the captured program's forward run eagerly over its
input buffers; ``tests/test_torch_cuda.py`` holds the CUDA graph itself."""
import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import RESNET_SMOKE as JSMOKE
from repro.core import comm as jcomm, mpc_tensor as jmpc
from repro.models import resnet as jres
from repro_torch import api as tapi, errors
from repro_torch.api.compile import replay_cache_stats
from repro_torch.configs import RESNET_SMOKE as TSMOKE
from repro_torch.core import beaver, comm as tcomm, mpc_tensor as tmpc, prng, ring as tring
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import resnet as tres
from repro_torch.runtime import loop as loop_lib

D_IN, D_HID, D_OUT = 6, 5, 4
HW = 8


class JLoopCfg:
    name = "loop-mlp"


class TLoopCfg:
    name = "loop-mlp"


def _japply(params, x, relu_fn=None):
    rf = relu_fn if relu_fn is not None else (lambda v, g: jax.nn.relu(v))
    return rf(rf(x @ params["w1"], 0) @ params["w2"], 1)


def _tapply(params, x, relu_fn=None):
    rf = relu_fn if relu_fn is not None else (lambda v, g: torch.relu(v))
    return rf(rf(x @ params["w1"], 0) @ params["w2"], 1)


def _loop_forward(params, hs, cfg, relu_fn, comm):
    hs = relu_fn([h.matmul_public(params["w1"]) for h in hs], 0)
    return relu_fn([h.matmul_public(params["w2"]) for h in hs], 1)


japi.register_mpc_forward(JLoopCfg, _loop_forward)
tapi.register_mpc_forward(TLoopCfg, _loop_forward)


def _np_weights(seed):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.standard_normal((D_IN, D_HID)) * 0.4).astype(np.float32),
            "w2": (rng.standard_normal((D_HID, D_OUT)) * 0.4).astype(np.float32)}


def _tparams(w):
    return {k: torch.from_numpy(v) for k, v in w.items()}


def _hb(api, plan):
    return plan.with_hb(api.HBConfig((api.HBLayer(k=21, m=13),) * 2,
                                     plan.group_elements))


@pytest.fixture(scope="module")
def mlp():
    w = _np_weights(0)
    tplan = _hb(tapi, tapi.trace_plan(_tapply, _tparams(w), (2, D_IN)))
    return w, tplan


def _shares(seed, shape=(2, D_IN)):
    """The same input shares for both packages: shared by the reference,
    carried to the port as (lo, hi) limbs."""
    x = np.random.default_rng(seed).uniform(-2, 2, shape).astype(np.float32)
    jX = jmpc.MPCTensor.from_plain(jax.random.PRNGKey(seed), jax.numpy.asarray(x))
    return jX, _to_port(jX)


def _to_port(jX):
    return tmpc.MPCTensor(tring.from_limbs(np.asarray(jX.data.lo),
                                           np.asarray(jX.data.hi), "cpu"))


def _equal_ref(t, j):
    lo, hi = tring.to_limbs(t.data)
    np.testing.assert_array_equal(lo, np.asarray(j.data.lo))
    np.testing.assert_array_equal(hi, np.asarray(j.data.hi))


def _port_model(w, plan, monkeypatch, mode, comm=None, provider=None):
    monkeypatch.setenv("HB_ROUND_LOOP", mode)
    cc = comm if comm is not None else tcomm.CoalescingComm()
    session = tapi.Session(key=0, comm=cc, provider=provider, device="cpu")
    return tapi.compile(_tapply, _tparams(w), TLoopCfg(), plan, session), cc


def _counters(cc):
    return cc.n_rounds, list(cc.round_bytes), list(cc.round_parts)


def test_round_loop_mode_env(monkeypatch):
    monkeypatch.delenv("HB_ROUND_LOOP", raising=False)
    assert loop_lib.round_loop_mode() == "scan"        # the default
    monkeypatch.setenv("HB_ROUND_LOOP", "python")
    assert loop_lib.round_loop_mode() == "python"
    monkeypatch.setenv("HB_ROUND_LOOP", "scan")
    assert loop_lib.round_loop_mode() == "scan"
    monkeypatch.setenv("HB_ROUND_LOOP", "bogus")
    assert loop_lib.round_loop_mode() == "scan"        # unknown -> default


def test_compiled_eligible_exact_types():
    class SubSim(tcomm.SimComm):
        pass

    class SubCoalescing(tcomm.CoalescingComm):
        pass

    assert loop_lib.compiled_eligible(tcomm.SimComm())
    assert loop_lib.compiled_eligible(tcomm.CoalescingComm(tcomm.SimComm()))
    assert not loop_lib.compiled_eligible(tcomm.CountingComm())
    assert not loop_lib.compiled_eligible(
        tcomm.CoalescingComm(tcomm.CountingComm()))
    assert not loop_lib.compiled_eligible(SubSim())
    assert not loop_lib.compiled_eligible(SubCoalescing(tcomm.SimComm()))
    assert not loop_lib.compiled_eligible(tcomm.CoalescingComm(SubSim()))


def test_private_model_scan_vs_python_vs_reference(mlp, monkeypatch):
    """The tiny MLP at (21, 13): the port's scan (its first call, the
    generator loop that records the layout, then two replays) equals its
    python loop and the reference's compiled scan, bit for bit; counters
    equal too, and the replay carries the reference's round count."""
    w, tplan = mlp
    jX, tX = _shares(8)
    monkeypatch.setenv("HB_ROUND_LOOP", "scan")
    monkeypatch.setenv("HB_XLA_OPT", "0")      # cap the reference's compile time
    jparams = {k: jax.numpy.asarray(v) for k, v in w.items()}
    jplan = _hb(japi, japi.trace_plan(_japply, jparams, (2, D_IN)))
    jcc = jcomm.CoalescingComm(jcomm.SimComm())
    jm = japi.compile(_japply, jparams, JLoopCfg(), jplan,
                      japi.Session(key=0, comm=jcc))
    jout = jm(jX, key=jax.random.PRNGKey(4))
    outs = {}
    for mode in ("python", "scan"):
        model, cc = _port_model(w, tplan, monkeypatch, mode)
        outs[mode] = [model(tX, key=prng.PRNGKey(4, "cpu")) for _ in range(3)]
        n, round_bytes, round_parts = _counters(jcc)
        assert _counters(cc) == (3 * n, 3 * round_bytes, 3 * round_parts)
        _equal_ref(outs[mode][0], jout)
    for a, b in zip(outs["python"], outs["scan"]):
        assert torch.equal(a.data, b.data)
    stats = model.replay_stats([tX])
    assert stats["n_rounds"] == jm.replay_stats([jX])["n_rounds"] == jcc.n_rounds
    assert stats["n_rounds"] == tplan.schedule().n_rounds
    assert (stats["trace_s"], stats["compile_s"]) == (0.0, 0.0)   # no graph on the CPU


def test_replay_static_buffers_and_pool(mlp, monkeypatch):
    """From an offline pool: each replay refills its buffers, so two calls
    with other inputs and other triples each give the generator loop's
    result, and a result held across the next replay is unchanged; a pool
    one call short raises ``TriplePoolExhausted`` before the replay runs,
    at the position the generator loop reaches."""
    w, tplan = mlp
    shares = [_shares(20 + i)[1] for i in range(3)]
    runs = {}
    for mode in ("python", "scan"):
        pool = beaver.EagerTTP(prng.PRNGKey(9, "cpu"), tplan.triple_specs(),
                               cone=tplan.cone, requests=3)
        model, cc = _port_model(w, tplan, monkeypatch, mode, provider=pool)
        runs[mode] = []
        for X in shares:
            runs[mode].append(model(X))
            if mode == "scan" and len(runs[mode]) == 2:
                held = runs[mode][1].data.clone()
        assert _counters(cc)[0] == 3 * tplan.schedule().n_rounds
        with pytest.raises(errors.TriplePoolExhausted):
            model(shares[0])
        runs[mode].append(pool.consumed)
    assert runs["scan"][3] == runs["python"][3]
    assert torch.equal(runs["scan"][1].data, held)
    for a, b in zip(runs["python"][:3], runs["scan"][:3]):
        assert torch.equal(a.data, b.data)
    assert not torch.equal(runs["scan"][1].data, runs["scan"][2].data)


def test_private_model_replay_cache_shared(mlp, monkeypatch):
    """A second model from the same plan and forward, with other weights of
    the same shapes, reuses the replay (no new cache entry) and gets its
    own result: the params are inputs of the replay, not baked in."""
    w, tplan = mlp
    _, tX = _shares(17)
    m1, _ = _port_model(w, tplan, monkeypatch, "scan")
    for _ in range(2):
        m1(tX, key=prng.PRNGKey(5, "cpu"))
    n_entries = len(replay_cache_stats())
    w2 = _np_weights(1)
    m2, _ = _port_model(w2, tplan, monkeypatch, "scan")
    got = [m2(tX, key=prng.PRNGKey(5, "cpu")) for _ in range(2)]
    assert len(replay_cache_stats()) == n_entries
    ref, _ = _port_model(w2, tplan, monkeypatch, "python")
    want = ref(tX, key=prng.PRNGKey(5, "cpu"))
    for g in got:
        assert torch.equal(g.data, want.data)
    assert not torch.equal(got[1].data, m1(tX, key=prng.PRNGKey(5, "cpu")).data)


def test_ineligible_comm_stays_on_generator_loop(mlp, monkeypatch):
    """A counting comm takes the generator loop even on scan: same
    outputs, counters measured live, no replay built."""
    w, tplan = mlp
    _, tX = _shares(27, (3, D_IN))     # a signature no other test replays
    cc = tcomm.CoalescingComm(tcomm.CountingComm())
    model, _ = _port_model(w, tplan, monkeypatch, "scan", comm=cc)
    out = model(tX, key=prng.PRNGKey(4, "cpu"))
    assert model.replay_stats([tX]) is None
    ref, cc_py = _port_model(w, tplan, monkeypatch, "python")
    assert torch.equal(out.data, ref(tX, key=prng.PRNGKey(4, "cpu")).data)
    assert cc.n_rounds == cc_py.n_rounds == cc.base.n_swaps


def test_serve_step(mlp, monkeypatch):
    """``serve_step(None)`` is ``__call__`` on the share tensor, with the
    session's provider or a given pool; ``jit_step`` caches it; a mesh
    without a party axis raises the reference's ``ValueError``."""
    w, tplan = mlp
    _, tX = _shares(31)
    model, _ = _port_model(w, tplan, monkeypatch, "scan")
    step = model.jit_step()
    assert step is model.jit_step(None)
    key = prng.PRNGKey(6, "cpu")
    want = model(tX, key=key)
    for _ in range(2):
        assert torch.equal(step(model.params, tX.data, None, key), want.data)
    triples = beaver.gen_plan_triples(prng.PRNGKey(3, "cpu"), tplan.triple_specs())
    pooled, _ = _port_model(w, tplan, monkeypatch, "python",
                            provider=beaver.TriplePool(triples))
    assert torch.equal(step(model.params, tX.data, triples, key),
                       pooled(tX, key=key).data)
    with pytest.raises(ValueError, match="carry no 'party' axis"):
        model.serve_step(mesh=make_smoke_mesh("cpu"))
    with pytest.raises(ValueError, match="carry no 'party' axis"):
        model.jit_step(mesh=make_smoke_mesh("cpu"))


def _np_resnet_params():
    rng = np.random.default_rng(0)

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        shape = tuple(tree.shape)
        if name in ("gamma", "var"):
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        if name in ("beta", "mean", "b"):
            return rng.normal(0, 0.05, shape).astype(np.float32)
        return (rng.standard_normal(shape) * 0.3).astype(np.float32)
    return walk(tres.init(TSMOKE, 0, "cpu"))


@pytest.mark.parametrize("reduced,cone", [(False, False), (True, True)],
                         ids=["exact", "reduced-cone"])
def test_resnet_scan_equals_reference(reduced, cone, monkeypatch):
    """RESNET_SMOKE, 2 sibling streams, triples from an offline pool: the
    port's scan (the signature's first call, then a replay on other
    inputs) equals the reference's generator loop bit for bit, and its
    replayed counters equal the schedule."""
    npp = _np_resnet_params()
    jp = jax.tree_util.tree_map(jax.numpy.asarray, npp)
    tp = tres.params_from_jax(npp, "cpu")
    jplan = jres.trace(jp, JSMOKE, 1, HW, cone=cone)
    tplan = tres.trace(tp, TSMOKE, 1, HW, cone=cone)
    if reduced:
        layers = [japi.HBLayer(k=21, m=13)] * (jplan.n_groups - 1) + [
            japi.HBLayer(k=13, m=13)]
        jplan = jplan.with_hb(japi.HBConfig(tuple(layers), jplan.group_elements))
        tplan = tplan.with_hb(tapi.HBConfig(
            tuple(tapi.HBLayer(k=l.k, m=l.m) for l in layers), tplan.group_elements))
    monkeypatch.setenv("HB_ROUND_LOOP", "python")
    jcc = jcomm.CoalescingComm()
    js = japi.Session(key=5, comm=jcc).offline(jax.random.PRNGKey(9), jplan,
                                                requests=2, streams=2)
    jm = japi.compile(lambda p, x, relu_fn=None: jres.apply(p, x, JSMOKE, relu_fn),
                      jp, JSMOKE, jplan, js)
    calls = [[_shares(40 + 2 * c + i, (1, 3, HW, HW))[0] for i in range(2)]
             for c in range(2)]
    jouts = [jm(jX) for jX in calls]
    monkeypatch.setenv("HB_ROUND_LOOP", "scan")
    tcc = tcomm.CoalescingComm()
    ts = tapi.Session(key=5, comm=tcc, device="cpu").offline(
        prng.PRNGKey(9, "cpu"), tplan, requests=2, streams=2)
    tm = tapi.compile(None, tp, TSMOKE, tplan, ts)
    sched = tplan.schedule(streams=2)
    for jX, jout in zip(calls, jouts):
        r0, b0 = tcc.n_rounds, tcc.bytes_tx
        touts = tm([_to_port(X) for X in jX])
        assert (tcc.n_rounds - r0, tcc.bytes_tx - b0) == (sched.n_rounds,
                                                          sched.bytes_tx)
        for to, jo in zip(touts, jout):
            _equal_ref(to, jo)
    assert tm.replay_stats([_to_port(X) for X in calls[0]])["n_rounds"] == \
        sched.n_rounds
