"""The port's twins of three reference examples, ``tools/quickstart.py``,
``tools/api_smoke.py`` and ``tools/serving_engine.py``, against the
reference package:

- quickstart: the reference script and the twin (``--device cpu``) print
  the same share, communication, rounds and threshold lines, and reveal
  within 1e-3; fed the reference's float input, both packages'
  ``from_plain`` and ``relu`` give the same shares bit for bit;
- api_smoke: the twin finishes with its asserts, and its plan (line, JSON,
  ``digest()``) equals ``repro.api.trace_plan``'s with the same
  assignment;
- serving_engine: at its defaults and with ``--merge-identical`` the
  batch's measured, predicted and serial rounds, the saved ratio, each
  tenant's metered usage and the Gantt chart equal the reference engine's
  pricing of the same mix and plan (its GMW is not run);
- every one of the five twins raises without a card when no ``--device``
  is given;
- ``chip_smoke.resnet_matmul_shapes``, which prices the examples phase's
  ring_matmul launches, equals the convs and the fc of the reference's
  forward (its jaxpr), and for ResNet-18 the main path's shape table.

The reference's plans are traced from abstract params (``jax.eval_shape``)
and every expected figure comes from ``repro``, never from the port's own
copies of ``schedule`` or ``costmodel``.
"""
import importlib.util
import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import RESNET_SMOKE as JSMOKE
from repro.core import MPCTensor as JMPCTensor, schedule as jschedule
from repro.core.hummingbird import HBConfig as JHBConfig, HBLayer as JHBLayer
from repro.models import resnet as jres
from repro.serve import BatchPolicy as JBatchPolicy, InferenceEngine as JEngine
from repro_torch.core import HBLayer, MPCTensor, prng, ring

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import api_smoke  # noqa: E402
import chip_smoke  # noqa: E402
import private_inference  # noqa: E402
import quickstart  # noqa: E402
import serving_engine  # noqa: E402
import two_party_serving  # noqa: E402

TWINS = {"quickstart": quickstart, "api_smoke": api_smoke,
         "serving_engine": serving_engine, "private_inference": private_inference,
         "two_party_serving": two_party_serving}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load_example(name: str):
    """``examples/<name>.py`` as a module (the reference's own script)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def line_with(out: str, mark: str) -> str:
    (line,) = [x for x in out.splitlines() if mark in x]
    return line


def printed_array(out: str, mark: str) -> np.ndarray:
    line = line_with(out, mark)
    return np.array([float(v) for v in line[line.index("[", len(mark)) + 1:
                                             line.rindex("]")].split()])


def jafn(p, v, relu_fn=None):
    return jres.apply(p, v, JSMOKE, relu_fn=relu_fn)


def jparams():
    """The reference's RESNET_SMOKE params as shapes only: tracing needs no
    values."""
    return jax.eval_shape(lambda k: jres.init(k, JSMOKE), jax.random.PRNGKey(0))


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def test_quickstart_twin_prints_the_reference_lines(capsys):
    load_example("quickstart").main()
    ref = capsys.readouterr().out
    got = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert last_json(out) == got
    for mark in ("party 0 share:", "communication:", "Theorem 2"):
        assert line_with(out, mark) == line_with(ref, mark)
    np.testing.assert_allclose(got["exact"], printed_array(ref, "exact ReLU:"), atol=1e-3)
    np.testing.assert_allclose(got["hb"], printed_array(ref, "HB ReLU [k=21,m=13]:"),
                               atol=1e-3)


def test_quickstart_shares_and_reveals_bit_identical():
    """The reference's own float input, as numpy, through both packages'
    ``from_plain`` and ``relu`` at (64, 0) and (21, 13), same keys."""
    xn = np.array(jax.random.normal(jax.random.PRNGKey(0), (8,)) * 3.0)
    XJ = JMPCTensor.from_plain(jax.random.PRNGKey(1), jnp.asarray(xn))
    XT = MPCTensor.from_plain(prng.PRNGKey(1, "cpu"), torch.from_numpy(xn))
    assert torch.equal(XT.data, ring.from_limbs(XJ.data.lo, XJ.data.hi, "cpu"))
    for seed, (k, m) in ((2, (64, 0)), (3, (21, 13))):
        yj = XJ.relu(jax.random.PRNGKey(seed), hb=JHBLayer(k=k, m=m))
        yt = XT.relu(prng.PRNGKey(seed, "cpu"), hb=HBLayer(k=k, m=m))
        assert torch.equal(yt.data, ring.from_limbs(yj.data.lo, yj.data.hi, "cpu"))
        np.testing.assert_array_equal(yt.reveal_np(), yj.reveal_np())


# ---------------------------------------------------------------------------
# api_smoke
# ---------------------------------------------------------------------------

def test_api_smoke_twin_plan_equals_the_reference(capsys):
    got = api_smoke.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert last_json(out) == got
    plan = japi.trace_plan(jafn, jparams(), (2, 3, 8, 8), name="smoke")
    plan = plan.with_hb(JHBConfig(tuple([JHBLayer(k=21, m=13)] * (plan.n_groups - 1)
                                        + [JHBLayer(k=13, m=13)]), plan.group_elements))
    line = (f"plan: {len(plan.calls)} ReLU calls, {plan.n_groups} groups, "
            f"{plan.cost().bytes_tx} B/party, {plan.cost().rounds} rounds, "
            f"LAN estimate {plan.estimate(network=japi.LAN)*1e3:.2f} ms")
    assert got["plan_line"] == line == out.splitlines()[0]
    assert json.dumps(got["plan"], sort_keys=True) == \
        json.dumps(plan.to_json(), sort_keys=True)
    assert got["digest"] == plan.digest()
    assert "serve_step (offline TriplePool) matches: OK" in out
    assert np.argmax(got["served"], -1).tolist() == got["argmax"]


# ---------------------------------------------------------------------------
# serving_engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("merge", [False, True])
def test_serving_engine_twin_equals_the_reference_engine(merge, capsys):
    got = serving_engine.main(["--device", "cpu"] + (["--merge-identical"] if merge else []))
    out = capsys.readouterr().out
    assert last_json(out) == got
    plan = japi.trace_plan(jafn, jparams(), (2, 3, 8, 8), name=JSMOKE.name)
    plan = plan.with_hb(JHBConfig(tuple([JHBLayer(k=21, m=13)] * plan.n_groups),
                                  plan.group_elements))
    engine = JEngine(jafn, jparams(), JSMOKE, plan, japi.Session(key=0),
                     policy=JBatchPolicy(network="lan", max_batch=8, merge_identical=merge),
                     tenant_budgets={"bob": 200_000})
    mix = serving_engine.MIX
    sched = engine._merged_schedule([types.SimpleNamespace(shape=s) for _, s in mix])
    serial = sum(engine.plan_for_shape(s).schedule().n_rounds for _, s in mix)
    assert (got["batches"], got["n_requests"]) == (1, 3)
    assert (got["measured_rounds"], got["predicted_rounds"], got["serial_rounds"]) == \
        (sched.n_rounds, sched.n_rounds, serial)
    assert (got["measured_bytes"], got["predicted_bytes"]) == (sched.bytes_tx,) * 2
    assert got["rounds_saved_ratio"] == serial / sched.n_rounds
    assert (f"one fused micro-batch of 3 requests: {sched.n_rounds} rounds measured "
            f"(schedule predicted {sched.n_rounds}); serial execution would pay "
            f"{serial} -> {serial / sched.n_rounds:.1f}x rounds saved") in out
    # the reference's metering, driven as the engine draws: each request's
    # calls in order on its tenant's provider (inline triples: no values)
    for tenant, shape in mix:
        for n, w in engine.plan_for_shape(shape).triple_specs():
            engine.tenant_provider(tenant).relu_triples(n, w, cone=plan.cone)
    for tenant in ("alice", "bob"):
        assert got["tenant_usage"][tenant] == engine.tenant_usage(tenant)
        assert f"{tenant} triples: {engine.tenant_usage(tenant)}" in out.splitlines()
    gantt = jschedule.simulate_merged(
        [engine.plan_for_shape((b, 3, 8, 8)).call_specs()[:1] for _, (b, *_r) in mix],
        auto_batch=False).gantt()
    assert got["gantt"] == gantt
    assert "\n" + gantt + "\n" in out


# ---------------------------------------------------------------------------
# every twin: the card by default
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_without_a_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        TWINS[name].main([])


# ---------------------------------------------------------------------------
# chip_smoke's ring_matmul shapes
# ---------------------------------------------------------------------------

def reference_matmuls(cfg, hw: int, rows: int) -> list:
    """(M, K, N, launches) of the reference's ResNet forward on one hw x hw
    image, read from its jaxpr: each conv at M = rows x OH x OW, K = Cin x
    kh x kw, N = Cout; the fc at M = rows."""
    params = jax.eval_shape(lambda k: jres.init(k, cfg), jax.random.PRNGKey(0))
    closed = jax.make_jaxpr(lambda p, x: jres.apply(p, x, cfg))(
        params, jax.ShapeDtypeStruct((1, 3, hw, hw), jnp.float32))
    found = {}

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "conv_general_dilated":
                cout, cin, kh, kw = eqn.invars[1].aval.shape
                oh, ow = eqn.outvars[0].aval.shape[-2:]
                key = (rows * oh * ow, cin * kh * kw, cout)
                found[key] = found.get(key, 0) + 1
            elif eqn.primitive.name == "dot_general":
                key = (rows, *eqn.invars[1].aval.shape)
                found[key] = found.get(key, 0) + 1
            for v in eqn.params.values():
                sub = getattr(v, "jaxpr", v)
                if hasattr(sub, "eqns"):
                    walk(sub)

    walk(closed.jaxpr)
    return sorted((m, k, n, c) for (m, k, n), c in found.items())


@pytest.mark.parametrize("name, hw, rows", [("resnet18", 32, 2),
                                            ("resnet-smoke", 16, 32),
                                            ("resnet-smoke", 8, 2)])
def test_chip_smoke_matmul_shapes_are_the_reference_convs(name, hw, rows):
    from repro import configs as jconfigs
    from repro_torch import configs

    cfg, jcfg = {"resnet18": (configs.RESNET18, jconfigs.RESNET18),
                 "resnet-smoke": (configs.RESNET_SMOKE, JSMOKE)}[name]
    got = sorted(chip_smoke.resnet_matmul_shapes(cfg, hw, rows))
    assert got == reference_matmuls(jcfg, hw, rows)
    if name == "resnet18":
        assert got == sorted((m, k, n, c // chip_smoke.STREAMS)
                             for m, k, n, c in chip_smoke.RING_MATMUL_SHAPES)

