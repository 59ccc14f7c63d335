"""The port's frozen seed oracle (``core/gmw_ref.py``), ``xor_reconstruct``
and the deprecated shims (``models/resnet.py``'s ``relu_plan``,
``gen_mpc_triples``, ``mpc_apply``, ``mpc_apply_many``;
``nn/common.mpc_relu_many``) against the reference, bit for bit.

Mirrors the reference's ``tests/test_fused_engine.py`` (seed-oracle
identity, relu_many against single tensors, culling, the mpc_apply
cases), ``tests/test_compiled_loop.py``'s seed-oracle cases,
``tests/test_gmw.py``'s ``xor_reconstruct`` cases and
``tests/test_api.py``'s shim cases.  Each reference run that several cases
compare against runs once, in a module fixture."""
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import RESNET_SMOKE as JSMOKE
from repro.core import beaver as jbeaver, comm as jcomm, fixed as jfixed, \
    gmw_ref as jref, mpc_tensor as jmpc, ring as jring, shares as jshares
from repro.core.hummingbird import HBConfig as JHB, HBLayer as JL
from repro.models import resnet as jres
from repro.nn import common as jcommon
from repro_torch import api as tapi
from repro_torch.configs import RESNET_SMOKE as TSMOKE
from repro_torch.core import beaver as tbeaver, comm as tcomm, fixed as tfixed, \
    gmw as tgmw, gmw_ref as tref, mpc_tensor as tmpc, prng, ring as tring, \
    schedule, shares as tshares
from repro_torch.core.hummingbird import HBConfig as THB, HBLayer as TL
from repro_torch.kernels import ops
from repro_torch.models import resnet as tres
from repro_torch.nn import common as tcommon

ROOT = pathlib.Path(__file__).resolve().parents[1]
HW = 8



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are many small integer ops: on one thread
    they run as fast, and do not crowd the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _same(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(tring.to_uint64_np(t), jring.to_uint64_np(j))


def _shared(n: int, seed: int):
    """The same input shares in both packages (numpy-seeded values, equal
    keys)."""
    x = np.random.default_rng(seed).uniform(-3.9, 3.9, n).astype(np.float32)
    return (jshares.share(jax.random.PRNGKey(seed), jfixed.encode_np(x)),
            tshares.share(prng.PRNGKey(seed, "cpu"), tfixed.encode_np(x, device="cpu")))


# ---------------------------------------------------------------------------
# The seed oracle against the reference's and against the fused engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,m,cone", [
    (128, 64, 0, False), (128, 64, 0, True),      # the exact baseline
    (128, 21, 13, False), (128, 21, 13, True),    # the paper's (21, 13)
    (128, 20, 14, False), (128, 2, 1, False),     # w = 6; w = 1: no adder
    (128, 8, 0, False), (128, 8, 0, True),
    (300, 21, 13, False), (33, 8, 6, False),      # test_compiled_loop's
    (7, 9, 8, False), (5, 2, 0, False),           # ragged n (its (64, 64, 0)
                                                  # is the exact case above)
])
def test_relu_and_drelu_bit_identical_to_seed(n, k, m, cone):
    """Mirrors ``test_fused_engine.py::test_relu_bit_identical_to_seed_reference``
    (its six cases), ``test_drelu_and_adder_bit_identical_to_seed`` and
    ``test_compiled_loop.py::test_relu_scan_bit_identical_to_seed``: same
    keys and triples, the port's seed ``relu`` and ``drelu`` shares equal
    the reference's seed path and the port's fused engine, and the seed
    path's exchanges are one per AND level (``CountingComm``)."""
    jX, tX = _shared(n, 1000 + k * 64 + m)
    jt = jbeaver.gen_relu_triples(jax.random.PRNGKey(11), n, k - m, cone=cone)
    tt = tbeaver.gen_relu_triples(prng.PRNGKey(11, "cpu"), n, k - m, cone=cone)
    jkey, tkey = jax.random.PRNGKey(12), prng.PRNGKey(12, "cpu")
    want = jref.relu(jkey, jX, jt, jcomm.SimComm(), k=k, m=m, cone=cone)
    cm = tcomm.CountingComm()
    seed = tref.relu(tkey, tX, tt, cm, k=k, m=m, cone=cone)
    fused = tgmw.relu(tkey, tX, tt, tcomm.SimComm(), k=k, m=m, cone=cone)
    _same(seed, want)
    _same(fused, want)
    assert cm.n_swaps == schedule.stream_rounds(k - m, cone=cone)
    jd = jref.drelu(jkey, jX, jt, jcomm.SimComm(), k=k, m=m, cone=cone)
    _same(tref.drelu(tkey, tX, tt, tcomm.SimComm(), k=k, m=m, cone=cone), jd)
    _same(tgmw.drelu(tkey, tX, tt, tcomm.SimComm(), k=k, m=m, cone=cone), jd)


def test_seed_oracle_reaches_only_beaver_and(monkeypatch):
    """The seed path's one kernel is ``beaver_and`` in its plain form (the
    opened (d, e) given), once per AND; it packs and unpacks in plain torch
    and never reaches ``pack_ring``, ``ks_step`` or ``cone_step``."""
    calls = {}
    for name in ("beaver_and", "ks_mask", "ks_step", "ks_combine", "ks_level",
                 "cone_step", "pack", "pack_ring", "unpack"):
        real = getattr(ops, name)

        def spy(*args, _name=name, _real=real, **kwargs):
            calls.setdefault(_name, []).append(len(args) + len(kwargs))
            return _real(*args, **kwargs)

        monkeypatch.setattr(ops, name, spy)
    _, tX = _shared(96, 5)
    for cone in (False, True):
        calls.clear()
        tt = tbeaver.gen_relu_triples(prng.PRNGKey(1, "cpu"), 96, 8, cone=cone)
        tref.relu(prng.PRNGKey(2, "cpu"), tX, tt, tcomm.SimComm(), k=21, m=13,
                  cone=cone)
        assert set(calls) == {"beaver_and"}
        assert calls["beaver_and"] == [6] * (1 + 3)      # plain form, 1 + L ANDs


def _bench_multigroup():
    """``BENCH_relu.json``'s ``multigroup`` case in the port: its groups,
    numpy-seeded shares, and per-group keys and triples."""
    specs = [(g["n"], g["k"], g["m"]) for g in json.loads(
        (ROOT / "BENCH_relu.json").read_text())["multigroup"]["groups"]]
    xs, trs, keys = [], [], []
    for i, (n, k, m) in enumerate(specs):
        x = np.random.default_rng(i).uniform(-3.5, 3.5, n).astype(np.float32)
        xs.append(tshares.share(prng.PRNGKey(50 + i, "cpu"),
                                tfixed.encode_np(x, device="cpu")))
        trs.append(tbeaver.gen_relu_triples(prng.PRNGKey(60 + i, "cpu"), n, k - m))
        keys.append(prng.PRNGKey(40 + i, "cpu"))
    return specs, xs, trs, keys


def test_multigroup_seed_against_fused():
    """``BENCH_relu.json``'s ``multigroup`` (four groups): run through the
    seed oracle one group after another, 31 swaps and 696 576 B; through
    ``gmw.relu_many`` fused, 10 rounds and the same bytes; the same keys
    and triples per group give the same shares, hence the same reveals.
    The swaps and bytes are the file's own."""
    bench = json.loads((ROOT / "BENCH_relu.json").read_text())["multigroup"]
    specs, xs, trs, keys = _bench_multigroup()
    cm = tcomm.CountingComm()
    seed = [tref.relu(key, x, tr, cm, k=k, m=m)
            for key, x, tr, (_, k, m) in zip(keys, xs, trs, specs)]
    cc = tcomm.CoalescingComm()
    fused = tgmw.relu_many(keys, xs, trs, cc, [(k, m) for _, k, m in specs])
    assert (cm.n_swaps, cm.bytes_tx) == (bench["swaps_seed"], bench["bytes_seed"]) \
        == (31, 696576)
    assert (cc.n_rounds, cc.bytes_tx) == (bench["swaps_fused"], bench["bytes_fused"]) \
        == (10, 696576)
    for s, f in zip(seed, fused):
        assert torch.equal(s, f)
        np.testing.assert_array_equal(tfixed.decode_np(tshares.reconstruct(s)),
                                      tfixed.decode_np(tshares.reconstruct(f)))


# ---------------------------------------------------------------------------
# xor_reconstruct (tests/test_gmw.py's cases)
# ---------------------------------------------------------------------------

def test_xor_reconstruct_bin_triple():
    """Mirrors ``test_gmw.py::test_beaver_bin_triple``: c = a & b after
    ``xor_reconstruct``, each member equal to the reference's."""
    jt = jbeaver.gen_bin(jax.random.PRNGKey(3), (8, 16))
    tt = tbeaver.gen_bin(prng.PRNGKey(3, "cpu"), (8, 16))
    a, b, c = (tshares.xor_reconstruct(getattr(tt, f)) for f in "abc")
    assert torch.equal(c, a & b)
    for f, got in zip("abc", (a, b, c)):
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jshares.xor_reconstruct(getattr(jt, f))).view(np.int32))


@pytest.mark.parametrize("seed_path", [False, True], ids=["fused", "seed"])
def test_xor_reconstruct_and_open(seed_path):
    """Mirrors ``test_gmw.py::test_and_open``: XOR-shared words through
    ``and_open`` (the fused engine's and the seed oracle's) reconstruct to
    x & y, and the shares equal the reference's."""
    from repro.core import gmw as jgmw
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2 ** 32, (4, 8), dtype=np.uint64).astype(np.uint32)
    y = rng.integers(0, 2 ** 32, (4, 8), dtype=np.uint64).astype(np.uint32)
    jx = jshares.xor_share_packed(jax.random.PRNGKey(4), jax.numpy.asarray(x))
    jy = jshares.xor_share_packed(jax.random.PRNGKey(5), jax.numpy.asarray(y))
    jz = jgmw.and_open(jx, jy, jbeaver.gen_bin(jax.random.PRNGKey(6), (4, 8)),
                       jcomm.SimComm())
    tx = tshares.xor_share_packed(prng.PRNGKey(4, "cpu"),
                                  torch.from_numpy(x.view(np.int32)))
    ty = tshares.xor_share_packed(prng.PRNGKey(5, "cpu"),
                                  torch.from_numpy(y.view(np.int32)))
    and_open = tref.and_open if seed_path else tgmw.and_open
    tz = and_open(tx, ty, tbeaver.gen_bin(prng.PRNGKey(6, "cpu"), (4, 8)),
                  tcomm.SimComm())
    np.testing.assert_array_equal(tshares.xor_reconstruct(tz).numpy().view(np.uint32),
                                  x & y)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz).view(np.int32))


# ---------------------------------------------------------------------------
# mpc_relu_many and culling (tests/test_fused_engine.py)
# ---------------------------------------------------------------------------

def test_mpc_relu_many_bit_identical_and_matches_single_tensors():
    """Mirrors ``test_fused_engine.py::test_relu_many_matches_individual_tensors``
    through ``nn.common.mpc_relu_many``: the port's shares equal the
    reference's, and each equals the same tensor's own ``.relu``."""
    rng = np.random.default_rng(3)
    shapes = [(24,), (4, 8), (2, 3, 5)]
    hbs = [(64, 0), (21, 13), (20, 14)]
    xs = [rng.uniform(-3, 3, s).astype(np.float32) for s in shapes]
    jts = [jmpc.MPCTensor.from_plain(jax.random.PRNGKey(100 + i), jax.numpy.asarray(x))
           for i, x in enumerate(xs)]
    tts = [tmpc.MPCTensor.from_plain(prng.PRNGKey(100 + i, "cpu"), torch.from_numpy(x))
           for i, x in enumerate(xs)]
    jkeys = [jax.random.PRNGKey(200 + i) for i in range(3)]
    tkeys = [prng.PRNGKey(200 + i, "cpu") for i in range(3)]
    want = jcommon.mpc_relu_many(jkeys, jts, hbs=[JL(k=k, m=m) for k, m in hbs])
    got = tcommon.mpc_relu_many(tkeys, tts, hbs=[TL(k=k, m=m) for k, m in hbs])
    for t, key, (k, m), g, w in zip(tts, tkeys, hbs, got, want):
        _same(g.data, w.data)
        assert torch.equal(t.relu(key, hb=TL(k=k, m=m)).data, g.data)
        np.testing.assert_allclose(g.reveal_np(), np.maximum(t.reveal_np(), 0),
                                   atol=2e-3)


def test_relu_identity_culling():
    """Mirrors ``test_fused_engine.py::test_relu_identity_culling``: k == m
    is the identity at zero communication, alone and beside a live group."""
    x = np.array([-1.5, -0.25, 0.5, 2.0], np.float32)
    X = tmpc.MPCTensor.from_plain(prng.PRNGKey(0, "cpu"), torch.from_numpy(x))
    cm = tcomm.CountingComm()
    assert X.relu(prng.PRNGKey(1, "cpu"), comm=cm, hb=TL(k=13, m=13)) is X
    assert cm.n_swaps == 0
    Y = tmpc.MPCTensor.from_plain(prng.PRNGKey(2, "cpu"), torch.from_numpy(x))
    outs = tcommon.mpc_relu_many([prng.PRNGKey(3, "cpu"), prng.PRNGKey(4, "cpu")],
                                 [X, Y], hbs=[TL(k=13, m=13), TL(k=21, m=13)],
                                 comm=cm)
    assert outs[0] is X
    np.testing.assert_allclose(outs[1].reveal_np(), np.maximum(x, 0), atol=2e-3)


# ---------------------------------------------------------------------------
# The deprecated ResNet shims (tests/test_api.py, tests/test_fused_engine.py)
# ---------------------------------------------------------------------------

def _np_params(seed: int = 0):
    """A RESNET_SMOKE params tree in the reference's layout, drawn with
    numpy, non-trivial BatchNorm statistics included."""
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name in ("gamma", "var"):
            return rng.uniform(0.8, 1.2, shape)
        if name in ("beta", "mean"):
            return rng.normal(0, 0.05, shape)
        if name == "b":
            return np.zeros(shape)
        if len(shape) == 4:
            return rng.standard_normal(shape) * (2.0 / np.prod(shape[1:])) ** 0.5
        return rng.standard_normal(shape) * shape[0] ** -0.5

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return leaf(name, tuple(tree.shape)).astype(np.float32)
    return walk(tres.init(TSMOKE, 0, "cpu"))


def _mixed(layers_cls, hb_cls, n_groups, elements):
    """(21, 13) on every group but the last, which is culled."""
    return hb_cls(tuple([layers_cls(k=21, m=13)] * (n_groups - 1)
                        + [layers_cls(k=13, m=13)]), tuple(elements))


@pytest.fixture(scope="module")
def shims():
    """The reference's shims run once: ``mpc_apply`` on one input (inline
    triples) and ``mpc_apply_many`` on two with ``gen_mpc_triples``'s
    pools per stream, under the mixed plan (the culled group's bundles are
    None)."""
    np_params = _np_params()
    jp = jax.tree_util.tree_map(jax.numpy.asarray, np_params)
    tp = tres.params_from_jax(np_params, "cpu")
    counts = tres.relu_group_elements(tp, TSMOKE, HW)
    n_groups = tres.n_relu_groups(TSMOKE)
    jhb, thb = _mixed(JL, JHB, n_groups, counts), _mixed(TL, THB, n_groups, counts)
    rng = np.random.default_rng(1)
    xs = [rng.uniform(-1, 1, (1, 3, HW, HW)).astype(np.float32) for _ in range(2)]
    jX = [jmpc.MPCTensor.from_plain(jax.random.PRNGKey(20 + i), jax.numpy.asarray(x))
          for i, x in enumerate(xs)]
    jplan = jres.relu_plan(jp, JSMOKE, batch=1, hw=HW)
    jtri = [jres.gen_mpc_triples(jax.random.PRNGKey(50 + i), jplan, jhb, JSMOKE)
            for i in range(2)]
    ref = {
        "apply": jres.mpc_apply(jp, jX[0], JSMOKE, jax.random.PRNGKey(3), hb=jhb),
        "many": jres.mpc_apply_many(jp, jX, JSMOKE, jax.random.PRNGKey(6), hb=jhb,
                                    triples=[list(c) for c in zip(*jtri)]),
        "plan": jplan, "triples": jtri}
    tX = [tmpc.MPCTensor(tring.from_limbs(np.asarray(X.data.lo), np.asarray(X.data.hi),
                                          "cpu")) for X in jX]
    return tp, thb, xs, tX, ref


def _legacy_mpc_apply(params, x, cfg, key, hb=None, comm=None, triples=None):
    """The seed-era ``mpc_apply`` body (``tests/test_api.py``'s frozen
    pre-refactor replay), in the port."""
    comm = comm or tcomm.SimComm()
    hb_layers = (hb.layers if hb is not None else
                 tuple(TL() for _ in range(tres.n_relu_groups(cfg))))
    key_iter = iter(prng.split(key, 256))
    triple_iter = iter(triples) if triples is not None else None

    def _relu(ts, g):
        tri = next(triple_iter) if triple_iter is not None else None
        return [ts[0].relu(next(key_iter), comm=comm, hb=hb_layers[g], triples=tri)]

    return tres._mpc_forward(params, [x], cfg, _relu, comm)[0]


def test_relu_plan_and_gen_mpc_triples_bit_identical(shims):
    """``relu_plan`` equals the reference's call list; ``gen_mpc_triples``
    gives None for the culled group and bundles equal to the reference's."""
    tp, thb, _, _, ref = shims
    plan = tres.relu_plan(tp, TSMOKE, batch=1, hw=HW)
    assert plan == [tuple(c) for c in ref["plan"]]
    tri = tres.gen_mpc_triples(prng.PRNGKey(50, "cpu"), plan, thb, TSMOKE)
    assert any(t is None for t in tri)
    for t, j in zip(tri, ref["triples"][0]):
        assert (t is None) == (j is None)
        if t is not None:
            for tm, jm in ((t.b2a, j.b2a), (t.mult, j.mult)):
                for f in "abc":
                    _same(getattr(tm, f), getattr(jm, f))
            for f in "abc":
                np.testing.assert_array_equal(
                    getattr(t.bin_init, f).numpy(),
                    np.asarray(getattr(j.bin_init, f)).view(np.int32))


def test_mpc_apply_shim_bit_identical(shims):
    """Mirrors ``test_api.py::test_compile_bit_identical_to_prerefactor``:
    the shim, the api path and the seed-era replay give the same shares,
    equal to the reference's shim."""
    tp, thb, _, tX, ref = shims
    key = prng.PRNGKey(3, "cpu")
    shim = tres.mpc_apply(tp, tX[0], TSMOKE, key, hb=thb)
    _same(shim.data, ref["apply"].data)
    legacy = _legacy_mpc_apply(tp, tX[0], TSMOKE, key, hb=thb)
    assert torch.equal(legacy.data, shim.data)
    plan = tres.trace(tp, TSMOKE, 1, HW).with_hb(thb)
    model = tapi.compile(None, tp, TSMOKE, plan, tapi.Session(device="cpu"))
    assert torch.equal(model(tX[0], key=key).data, shim.data)


def test_mpc_apply_many_shim_with_offline_triples_bit_identical(shims):
    """Mirrors ``test_api.py::test_mpc_apply_many_shim_bit_identical`` and
    ``test_fused_engine.py::test_mpc_apply_many_with_offline_triples`` /
    ``test_culled_triples_plan``: two streams, one pool per stream from
    ``gen_mpc_triples`` (None for the culled group), consumed per call and
    stream; shares equal the reference's shim."""
    tp, thb, _, tX, ref = shims
    plan = tres.relu_plan(tp, TSMOKE, batch=1, hw=HW)
    per_stream = [tres.gen_mpc_triples(prng.PRNGKey(50 + i, "cpu"), plan, thb, TSMOKE)
                  for i in range(2)]
    outs = tres.mpc_apply_many(tp, tX, TSMOKE, prng.PRNGKey(6, "cpu"), hb=thb,
                               triples=[list(c) for c in zip(*per_stream)])
    for got, want in zip(outs, ref["many"]):
        _same(got.data, want.data)
        assert got.shape == (1, TSMOKE.n_classes)


def test_mpc_apply_matches_plaintext_and_streams_share_rounds(shims):
    """Mirrors ``test_fused_engine.py::test_mpc_apply_bit_identical_to_prerefactor_shape``
    and ``test_mpc_apply_many_round_fused_streams``: the exact shim's reveal
    is the plaintext forward within 2e-2, and two sibling streams take as
    many exchanges as one (``CountingComm``)."""
    tp, _, xs, tX, _ = shims
    key = prng.PRNGKey(5, "cpu")
    one, two = tcomm.CountingComm(), tcomm.CountingComm()
    single = tres.mpc_apply(tp, tX[0], TSMOKE, key, comm=one)
    outs = tres.mpc_apply_many(tp, tX, TSMOKE, key, comm=two)
    for x, out in zip(xs, outs):
        want = tres.apply(tp, torch.from_numpy(x), TSMOKE).numpy()
        np.testing.assert_allclose(out.reveal_np(), want, atol=2e-2)
    np.testing.assert_allclose(
        single.reveal_np(), tres.apply(tp, torch.from_numpy(xs[0]), TSMOKE).numpy(),
        atol=2e-2)
    assert one.n_swaps == two.n_swaps > 0
