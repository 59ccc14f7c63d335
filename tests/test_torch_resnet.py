"""The port's main path as a whole: RESNET_SMOKE private inference through
``api.compile`` and ``PrivateModel.__call__`` against the reference, plus
the rule that the port imports neither jax nor the reference package."""
import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import RESNET_SMOKE as JSMOKE
from repro.core import comm as jcomm, mpc_tensor as jmpc
from repro.models import resnet as jres
from repro_torch import api as tapi
from repro_torch.configs import RESNET_SMOKE as TSMOKE
from repro_torch.data import ImagePipeline
from repro_torch.core import comm as tcomm, mpc_tensor as tmpc, prng, ring as tring
from repro_torch.models import resnet as tres

ROOT = pathlib.Path(__file__).resolve().parents[1]
HW = 8


def _np_params(seed: int = 0):
    """A params tree in the reference's layout drawn with numpy (no cold
    jax.random compiles): conv and fc weights at the reference's init
    scales, and non-trivial BatchNorm statistics so BN folding is exercised."""
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
    return walk(tres.init(TSMOKE, 0, "cpu"))      # the port's tree as the skeleton


@pytest.fixture(scope="module")
def models():
    jp = jax.tree_util.tree_map(jax.numpy.asarray, _np_params())
    tp = tres.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jp, tp


def _jafn(p, x, relu_fn=None):
    return jres.apply(p, x, JSMOKE, relu_fn=relu_fn)


def _tafn(p, x, relu_fn=None):
    return tres.apply(p, x, TSMOKE, relu_fn=relu_fn)


def _reduced(api, plan):
    return plan.with_hb(api.HBConfig(
        tuple([api.HBLayer(k=21, m=13)] * (plan.n_groups - 1)
              + [api.HBLayer(k=13, m=13)]), plan.group_elements))


def test_plaintext_forward_matches(models):
    """float32 forward; sums run in another order, so atol 1e-5."""
    jp, tp = models
    x = np.random.default_rng(0).uniform(-1, 1, (2, 3, HW, HW)).astype(np.float32)
    want = np.asarray(_jafn(jp, x))
    with torch.no_grad():
        got = tres.ResNet(tp, TSMOKE)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("reduced", [False, True])
def test_plan_json_and_digest(models, reduced, tmp_path):
    jp, tp = models
    jplan, tplan = jres.trace(jp, JSMOKE, 1, HW), tres.trace(tp, TSMOKE, 1, HW)
    if reduced:
        jplan, tplan = _reduced(japi, jplan), _reduced(tapi, tplan)
    assert tplan.to_json() == jplan.to_json()
    assert tplan.digest() == jplan.digest()
    tplan.save(tmp_path / "plan.json")
    assert tapi.Plan.load(tmp_path / "plan.json") == tplan.validate()
    assert tplan.cost(streams=2).bytes_tx == jplan.cost(streams=2).bytes_tx


def test_cone_plan_json_and_digest(models):
    """``trace(..., cone=True)``: the cone flag rides the plan's JSON and
    digest, byte-identical to the reference's."""
    jp, tp = models
    jplan = jres.trace(jp, JSMOKE, 1, HW, cone=True)
    tplan = tres.trace(tp, TSMOKE, 1, HW, cone=True)
    assert tplan.cone and tplan.to_json() == jplan.to_json()
    assert tplan.digest() == jplan.digest() != tres.trace(tp, TSMOKE, 1, HW).digest()
    assert tplan.cost(streams=2).bytes_tx == jplan.cost(streams=2).bytes_tx


def test_folded_weight_encoding_matches():
    """fold_bn + encode_weights on non-trivial BatchNorm statistics: the
    float32 steps give the same int32 weights and biases in both packages."""
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.3, (16, 8, 3, 3)).astype(np.float32)
    bn = {"gamma": rng.uniform(0.5, 1.5, 16), "beta": rng.normal(0, 0.2, 16),
          "mean": rng.normal(0, 0.5, 16), "var": rng.uniform(0.2, 2.0, 16)}
    bn = {k: v.astype(np.float32) for k, v in bn.items()}
    jw, jb = jres.fold_bn(jax.numpy.asarray(w),
                          {k: jax.numpy.asarray(v) for k, v in bn.items()})
    tw, tb = tres.fold_bn(torch.from_numpy(w),
                          {k: torch.from_numpy(v) for k, v in bn.items()})
    for j, t in ((jw, tw), (jb, tb)):
        np.testing.assert_array_equal(tmpc.encode_weights(t, device="cpu").numpy(),
                                      np.asarray(jmpc.encode_weights(j)))


def _private_inference(models, reduced: bool, cone: bool = False):
    jp, tp = models
    jplan = jres.trace(jp, JSMOKE, 1, HW, cone=cone)
    tplan = tres.trace(tp, TSMOKE, 1, HW, cone=cone)
    if reduced:
        jplan, tplan = _reduced(japi, jplan), _reduced(tapi, tplan)
    jcc, tcc = jcomm.CoalescingComm(), tcomm.CoalescingComm()
    jm = japi.compile(_jafn, jp, JSMOKE, jplan, japi.Session(key=0, comm=jcc))
    tm = tapi.compile(_tafn, tp, TSMOKE, tplan,
                      tapi.Session(key=0, comm=tcc, device="cpu"))
    rng = np.random.default_rng(2)
    xs = [rng.uniform(-1, 1, (1, 3, HW, HW)).astype(np.float32) for _ in range(2)]
    jX = [jm.encrypt(jax.random.PRNGKey(10 + i), x) for i, x in enumerate(xs)]
    tX = [tmpc.MPCTensor(tring.from_limbs(np.asarray(X.data.lo),
                                          np.asarray(X.data.hi), "cpu"))
          for X in jX]
    jouts, touts = jm(jX), tm(tX)
    for jo, to in zip(jouts, touts):
        lo, hi = tring.to_limbs(to.data)
        np.testing.assert_array_equal(lo, np.asarray(jo.data.lo))
        np.testing.assert_array_equal(hi, np.asarray(jo.data.hi))
    sched = tplan.schedule(streams=2)
    assert (tcc.n_rounds, tcc.bytes_tx) == (sched.n_rounds, sched.bytes_tx)
    assert (tcc.n_rounds, tcc.bytes_tx) == (jcc.n_rounds, jcc.bytes_tx)
    if not reduced:
        want = np.concatenate([tm.plaintext(torch.from_numpy(x)).numpy()
                               for x in xs])
        got = np.concatenate([o.reveal_np() for o in touts])
        np.testing.assert_allclose(got, want, atol=2e-2)


@pytest.mark.parametrize("reduced", [False, True])
def test_private_inference_bit_identical(models, reduced):
    """2 sibling streams, same session key and input shares: output shares
    bit-identical; measured rounds and bytes equal plan.schedule(2)."""
    _private_inference(models, reduced)


def test_private_inference_cone_bit_identical(models):
    """The same under the reduced plan with ``cone=True``: the
    MSB-cone-pruned adder (w = 64 cone shares: tests/test_torch_gmw.py)."""
    _private_inference(models, reduced=True, cone=True)


@pytest.mark.parametrize("reduced,cone", [(False, False), (True, True)],
                         ids=["exact", "reduced-cone"])
def test_offline_session_bit_identical(models, reduced, cone):
    """``Session.offline``: the pool of 2 requests x 2 sibling streams
    (call-major / stream-minor) made up front from one TTP key; both
    calls' output shares equal the reference's through its own
    ``Session.offline`` with the same keys, rounds and bytes equal the
    schedule, and a third call finds the pool exhausted."""
    from repro_torch import errors
    jp, tp = models
    jplan = jres.trace(jp, JSMOKE, 1, HW, cone=cone)
    tplan = tres.trace(tp, TSMOKE, 1, HW, cone=cone)
    if reduced:
        jplan, tplan = _reduced(japi, jplan), _reduced(tapi, tplan)
    jcc, tcc = jcomm.CoalescingComm(), tcomm.CoalescingComm()
    js = japi.Session(key=5, comm=jcc).offline(jax.random.PRNGKey(9), jplan,
                                                requests=2, streams=2)
    ts = tapi.Session(key=5, comm=tcc, device="cpu").offline(
        prng.PRNGKey(9, "cpu"), tplan, requests=2, streams=2)
    assert ts.provider.device_bytes() > 0
    jm = japi.compile(_jafn, jp, JSMOKE, jplan, js)
    tm = tapi.compile(_tafn, tp, TSMOKE, tplan, ts)
    rng = np.random.default_rng(6)
    xs = [rng.uniform(-1, 1, (1, 3, HW, HW)).astype(np.float32) for _ in range(2)]
    jX = [jm.encrypt(jax.random.PRNGKey(20 + i), x) for i, x in enumerate(xs)]
    tX = [tmpc.MPCTensor(tring.from_limbs(np.asarray(X.data.lo),
                                          np.asarray(X.data.hi), "cpu"))
          for X in jX]
    for _ in range(2):
        for jo, to in zip(jm(jX), tm(tX)):
            lo, hi = tring.to_limbs(to.data)
            np.testing.assert_array_equal(lo, np.asarray(jo.data.lo))
            np.testing.assert_array_equal(hi, np.asarray(jo.data.hi))
    sched = tplan.schedule(streams=2)
    assert (tcc.n_rounds, tcc.bytes_tx) == (2 * sched.n_rounds, 2 * sched.bytes_tx)
    with pytest.raises(errors.TriplePoolExhausted):
        tm(tX)


def test_encrypt_matches_reference_shares(models):
    """The port's own input sharing equals the reference's for one key."""
    jp, tp = models
    x = np.random.default_rng(3).uniform(-1, 1, (1, 3, HW, HW)).astype(np.float32)
    jplan, tplan = jres.trace(jp, JSMOKE, 1, HW), tres.trace(tp, TSMOKE, 1, HW)
    jX = japi.compile(_jafn, jp, JSMOKE, jplan).encrypt(jax.random.PRNGKey(5), x)
    tX = tapi.compile(_tafn, tp, TSMOKE, tplan, tapi.Session(device="cpu")) \
        .encrypt(prng.PRNGKey(5, "cpu"), x)
    lo, hi = tring.to_limbs(tX.data)
    np.testing.assert_array_equal(lo, np.asarray(jX.data.lo))
    np.testing.assert_array_equal(hi, np.asarray(jX.data.hi))


def test_mpc_tensor_ops_bit_identical():
    """The MPCTensor surface beyond the ResNet forward: sub, mul_public,
    matmul_public, avg_pool, reshape and a single-tensor relu."""
    rng = np.random.default_rng(4)
    # (1, 8, 8, 8): the relu's 512 elements reuse the reference's compiled
    # ops of the whole-forward test above (its stage-2 merged ReLU and stem
    # triples have the same size)
    x = rng.uniform(-2, 2, (1, 8, 8, 8)).astype(np.float32)
    y = rng.uniform(-2, 2, (1, 8, 8, 8)).astype(np.float32)
    jx = jmpc.MPCTensor.from_plain(jax.random.PRNGKey(1), jax.numpy.asarray(x))
    jy = jmpc.MPCTensor.from_plain(jax.random.PRNGKey(2), jax.numpy.asarray(y))
    tx = tmpc.MPCTensor.from_plain(prng.PRNGKey(1, "cpu"), torch.from_numpy(x))
    ty = tmpc.MPCTensor.from_plain(prng.PRNGKey(2, "cpu"), torch.from_numpy(y))
    wmat = rng.normal(0, 0.5, (8, 3)).astype(np.float32)
    pairs = [((jx - jy).mul_public(0.75), (tx - ty).mul_public(0.75)),
             (jx.matmul_public(wmat), tx.matmul_public(torch.from_numpy(wmat))),
             (jx.avg_pool(2).reshape(1, 128), tx.avg_pool(2).reshape(1, 128)),
             (jx.relu(jax.random.PRNGKey(3)), tx.relu(prng.PRNGKey(3, "cpu")))]
    for j, t in pairs:
        lo, hi = tring.to_limbs(t.data)
        np.testing.assert_array_equal(lo, np.asarray(j.data.lo))
        np.testing.assert_array_equal(hi, np.asarray(j.data.hi))
    np.testing.assert_allclose(pairs[3][1].reveal_np(), np.maximum(x, 0), atol=2e-4)


@pytest.mark.parametrize("c", [0.75, 1.0 / 3.0, np.float32(-0.1), 2, np.float64(1e-3)],
                         ids=["float", "third", "np.float32", "int", "np.float64"])
def test_public_host_scalars_bit_identical(c):
    """A public constant given as a host number is encoded on the host (no
    copy from host memory, which a captured CUDA graph refuses), with the
    same shares as the device-tensor route and the reference: mul_public
    and add_public by c, avg_pool and global_avg_pool (which multiply by
    1 / window^2 and 1 / (h w))."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-2, 2, (1, 4, 6, 6)).astype(np.float32)
    jx = jmpc.MPCTensor.from_plain(jax.random.PRNGKey(6), jax.numpy.asarray(x))
    tx = tmpc.MPCTensor.from_plain(prng.PRNGKey(6, "cpu"), torch.from_numpy(x))
    tc = torch.tensor(np.float32(c))
    pairs = [(jx.mul_public(c), tx.mul_public(c), tx.mul_public(tc)),
             (jx.add_public(c), tx.add_public(c), tx.add_public(tc)),
             (jx.avg_pool(3), tx.avg_pool(3), None),
             (jx.global_avg_pool(), tx.global_avg_pool(), None)]
    for j, t, via_tensor in pairs:
        lo, hi = tring.to_limbs(t.data)
        np.testing.assert_array_equal(lo, np.asarray(j.data.lo))
        np.testing.assert_array_equal(hi, np.asarray(j.data.hi))
        if via_tensor is not None:
            assert torch.equal(t.data, via_tensor.data)


def test_session_keys_match_reference():
    """next_key walks the same stream; request_key is fold_in(seed, id)."""
    js, ts = japi.Session(key=7), tapi.Session(key=7, device="cpu")
    for _ in range(3):
        np.testing.assert_array_equal(ts.next_key().numpy(),
                                      np.asarray(js.next_key()).astype(np.int64))
    np.testing.assert_array_equal(ts.request_key(12).numpy(),
                                  np.asarray(js.request_key(12)).astype(np.int64))


def test_session_defaults_to_cuda():
    if torch.cuda.is_available():
        assert tapi.Session().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tapi.Session()


@pytest.mark.parametrize("make", [
    lambda d: prng.PRNGKey(0, d),
    lambda d: tres.init(TSMOKE, 0, d)["stem"],
    lambda d: tres.params_from_jax({"w": np.ones(3, np.float32)}, d)["w"],
    lambda d: tmpc.encode_weights(np.ones(3, np.float32), device=d),
    lambda d: tring.from_uint64_np(np.ones(3, np.uint64), d),
    lambda d: ImagePipeline(hw=4).take(2, device=d)[0],
], ids=["PRNGKey", "init", "params_from_jax", "encode_weights", "from_uint64_np",
        "ImagePipeline"])
def test_entry_points_default_to_cuda(make):
    """device=None means the GPU, and raises without one; "cpu" is honoured."""
    assert make("cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert make(None).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            make(None)


def test_deployment_entry_points_default_to_cuda(tmp_path):
    """The two-party deployment's entry points resolve ``device=None`` (and
    the CLIs' default ``--device``) to CUDA and raise without a card,
    before any socket is opened or any file read."""
    from repro_torch.launch import party_host
    from repro_torch.serve import frontend
    from repro_torch.transport import load_party, tenant_provider_factory

    entries = [
        lambda: tapi.Session.connect(0, listen=("127.0.0.1", 0)),
        lambda: load_party(tmp_path, 0),
        lambda: tenant_provider_factory(0, party=0),
        lambda: party_host.run(["--party", "0", "--job", str(tmp_path),
                                "--listen", "127.0.0.1:0"]),
        lambda: frontend.build_engine(frontend.build_parser().parse_args(
            ["--job", str(tmp_path), "--listen", "127.0.0.1:0"]), {}),
    ]
    assert party_host.build_parser().parse_args(
        ["--party", "1", "--job", "j", "--peer", ":1"]).device == "cuda"
    if torch.cuda.is_available():
        assert tenant_provider_factory(0, party=0)("t").base._key.device.type == "cuda"
        return
    for entry in entries:
        with pytest.raises(RuntimeError, match="no GPU"):
            entry()


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))
    assert len(files) > 20
    assert ROOT / "tools" / "train_lm.py" in files
    for twin in ("quickstart", "api_smoke", "serving_engine", "private_inference",
                 "two_party_serving", "private_lm"):
        assert ROOT / "tools" / f"{twin}.py" in files, twin
    assert ROOT / "src" / "repro_torch" / "runtime" / "loop.py" in files
    assert ROOT / "src" / "repro_torch" / "models" / "lm.py" in files
    assert ROOT / "src" / "repro_torch" / "nn" / "approx" / "pwl.py" in files
    for sub in ("search/engine.py", "search/simulator.py", "search/finetune.py",
                "data/pipeline.py", "train/optimizer.py", "nn/rope_tables.py",
                "serve/engine.py", "serve/frontend.py", "runtime/watchdog.py",
                "core/gmw_ref.py", "core/faults.py", "checkpoint/store.py",
                "transport/socket.py", "transport/job.py",
                "transport/engine_link.py", "launch/party_host.py",
                "analysis/lint.py", "analysis/locks.py", "analysis/census.py",
                "analysis/hbcheck.py", "analysis/__init__.py", "launch/train.py",
                "train/loop.py", "runtime/roofline.py", "runtime/op_analyzer.py"):
        assert ROOT / "src" / "repro_torch" / sub in files, sub
    bad = [(str(f.relative_to(ROOT)), name) for f in files for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
