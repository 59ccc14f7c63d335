"""The port's search engine (simulator, HummingBird-eco and -b, finetune)
and what it draws on (``ImagePipeline``, the SGD optimizer) against the
reference's, on the CPU; mirrors tests/test_search.py.

- ``simulated_hb_relu`` is integer arithmetic after ``fixed.encode``: bit
  for bit the reference's for the same float32 input and key, at w <= 32,
  w = 32, w > 32, k = m and (64, 0);
- on a model whose float arithmetic is exact in both packages (an MLP
  whose weights and inputs are small multiples of 2^-4, so every product
  and sum is a float32 without rounding), ``search_eco`` and
  ``search_budget`` (bytes and latency objectives, the WAN ordering) give
  the reference's config, accuracy, counters, objective value and visit
  order, and the same ``SearchResult.to_json()`` but for the time;
- on RESNET_SMOKE at 8x8 with the reference's weights carried across, the
  same configs (the convolutions round differently in the two packages;
  see ``test_resnet_smoke_searches_find_the_reference_configs``);
- one finetune ``train_step`` equals the reference's on tolerance, every
  leaf (BatchNorm statistics too) updated;
- the reference's own search tests, run on the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import RESNET_SMOKE as JSMOKE
from repro.core.hummingbird import HBConfig as JHB, HBLayer as JL
from repro.data import ImagePipeline as JPipeline
from repro.models import resnet as jres
from repro.search import engine as jeng, finetune as jft, simulator as jsim
from repro.train import optimizer as jopt
from repro_torch import api as tapi
from repro_torch.configs import RESNET_SMOKE as TSMOKE
from repro_torch.core import prng
from repro_torch.core.hummingbird import HBConfig, HBLayer
from repro_torch.data import ImagePipeline
from repro_torch.models import resnet as tres
from repro_torch.search import (engine as teng, finetune as tft, search_budget,
                                search_eco, simulator as tsim)
from repro_torch.train import optimizer as topt


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The simulator's threefry is many small int64 ops: on one thread they
    run as fast here, and do not crowd the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _key(seed):
    return prng.PRNGKey(seed, "cpu")


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# The simulator
# ---------------------------------------------------------------------------

KMS = [(21, 13), (21, 0), (16, 8), (9, 8), (32, 0), (40, 8), (48, 8), (64, 8),
       (60, 0), (64, 40), (13, 13), (64, 0)]


@pytest.mark.parametrize("k,m", KMS)
def test_simulated_hb_relu_bit_exact(k, m):
    """Same float32 input and key: the reference's output bits, at w <= 32
    (the reference's uint32 wraps, the port masks to w bits), w = 32,
    w > 32, k = m and (64, 0).  Zeros are compared as values: at (64, 0)
    the plain ReLU keeps -0.0 in torch and gives +0.0 in XLA."""
    rng = np.random.default_rng(k * 64 + m)
    x = rng.uniform(-6, 6, (4, 37)).astype(np.float32)
    x[0, :6] = [0.0, -0.0, 2.0 ** -16, -(2.0 ** -16), 2.0 ** (m - 16), -3.5]
    for seed in (0, 9):
        want = jsim.simulated_hb_relu(jnp.asarray(x), k, m, jax.random.PRNGKey(seed))
        got = tsim.simulated_hb_relu(torch.from_numpy(x), k, m, _key(seed))
        np.testing.assert_array_equal(_bits(got + 0.0), _bits(np.asarray(want) + 0.0))


def test_simulated_relu_matches_protocol_semantics(rng):
    x = torch.from_numpy(rng.uniform(-4, 4, (256,)).astype(np.float32))
    out = tsim.simulated_hb_relu(x, 21, 0, _key(0))
    np.testing.assert_allclose(out.numpy(), np.maximum(x.numpy(), 0), atol=1e-6)
    out2 = tsim.simulated_hb_relu(x, 21, 12, _key(1)).numpy()
    xn = x.numpy()
    exact = np.maximum(xn, 0)
    pruned = np.where((xn > 0) & (xn < 2.0 ** (12 - 16)), 0.0, exact)
    assert ((np.abs(out2 - exact) < 1e-5) | (np.abs(out2 - pruned) < 1e-5)).all()


def test_simulated_relu_width0_is_identity(rng):
    x = torch.from_numpy(rng.uniform(-4, 4, (64,)).astype(np.float32))
    assert torch.equal(tsim.simulated_hb_relu(x, 13, 13, _key(0)), x)


def test_group_relu_one_key_per_group():
    """``make_group_relu`` splits the key once per group: every call of a
    group draws the same share split (as the reference; not "fixed")."""
    cfg = HBConfig((HBLayer(21, 13), HBLayer(19, 13), HBLayer(18, 0)), (8, 8, 8))
    jcfg = JHB((JL(21, 13), JL(19, 13), JL(18, 0)), (8, 8, 8))
    x = np.random.default_rng(3).uniform(-2, 2, (2, 8)).astype(np.float32)
    t, j = tsim.make_group_relu(cfg, _key(4)), jsim.make_group_relu(jcfg, jax.random.PRNGKey(4))
    for g in (0, 1, 1, 2):
        np.testing.assert_array_equal(_bits(t(torch.from_numpy(x), g)),
                                      _bits(j(jnp.asarray(x), g)))
    assert torch.equal(t(torch.from_numpy(x), 1), t(torch.from_numpy(x), 1))


@pytest.mark.parametrize("cone", [False, True])
def test_config_objective_equals_the_reference(cone):
    calls = [(96, 0), (4096, 1), (4096, 1), (2048, 2)]
    for kms in (((21, 13), (18, 12), (13, 13)), ((64, 0), (22, 14), (30, 0))):
        t = HBConfig(tuple(HBLayer(k, m) for k, m in kms), (96, 8192, 2048))
        j = JHB(tuple(JL(k, m) for k, m in kms), (96, 8192, 2048))
        for streams in (1, 4):
            assert tsim.config_objective(t, calls, "bytes", streams=streams, cone=cone) \
                == jsim.config_objective(j, calls, "bytes", streams=streams, cone=cone)
            for net in tapi.NETWORKS.values():
                args = dict(bandwidth_bps=net.bandwidth_bps, rtt_s=net.rtt_s,
                            streams=streams, cone=cone)
                assert tsim.config_objective(t, calls, "latency", **args) == \
                    jsim.config_objective(j, calls, "latency", **args)
    with pytest.raises(ValueError, match="unknown objective"):
        tsim.config_objective(t, calls, "watts")
    with pytest.raises(ValueError, match="latency"):
        tsim.config_objective(t, calls, "latency")


# ---------------------------------------------------------------------------
# An exact-arithmetic model: the searches equal the reference's
# ---------------------------------------------------------------------------

def _mlp_params():
    """Weights in {-8..8} / 16; with inputs in {-8..8} / 16 every layer's
    products and sums are exact in float32 (at most 24 significant bits)."""
    rng = np.random.default_rng(11)
    return {f"w{i}": (rng.integers(-8, 9, shape) / 16).astype(np.float32)
            for i, shape in ((1, (8, 12)), (2, (12, 12)), (3, (12, 4)))}


def _japply(p, x, relu_fn=None):
    relu = relu_fn or (lambda v, g: jax.nn.relu(v))
    h = relu(x @ p["w1"], 0)
    h = relu(h @ p["w2"], 1)
    return h @ p["w3"]


def _tapply(p, x, relu_fn=None):
    relu = relu_fn or (lambda v, g: torch.relu(v))
    h = relu(x @ p["w1"], 0)
    h = relu(h @ p["w2"], 1)
    return h @ p["w3"]


@pytest.fixture(scope="module")
def mlp():
    params = _mlp_params()
    rng = np.random.default_rng(12)
    xs = (rng.integers(-8, 9, (96, 8)) / 16).astype(np.float32)
    logits = np.asarray(_japply(params, xs))
    ys = np.argmax(logits, -1)
    flip = rng.random(96) < 0.2                # a baseline below 1
    ys = np.where(flip, rng.integers(0, 4, 96), ys).astype(np.int32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jplan = japi.trace_plan(_japply, jp, (1, 8))
    tplan = tapi.trace_plan(_tapply, tp, (1, 8))
    assert tplan.to_json() == jplan.to_json()
    exact = _tapply(tp, torch.from_numpy(xs))
    np.testing.assert_array_equal(exact.numpy(), logits)   # exact in both
    return (dict(params=jp, xs=jnp.asarray(xs), ys=jnp.asarray(ys), plan=jplan),
            dict(params=tp, xs=torch.from_numpy(xs), ys=torch.from_numpy(ys).long(),
                 plan=tplan))


def _same_result(t, j):
    td, jd = t.to_json(), j.to_json()
    assert td.pop("search_time_s") >= 0 and jd.pop("search_time_s") >= 0
    assert td == jd


def test_max_activation_ints_equal_the_reference(mlp):
    j, t = mlp
    assert tsim.max_activation_ints(_tapply, t["params"], t["xs"], 2) == \
        jsim.max_activation_ints(_japply, j["params"], j["xs"], 2)


@pytest.mark.parametrize("objective,network,streams", [
    ("bytes", None, 1), ("latency", "wan", 4)])
def test_exact_model_eco_equals_the_reference(mlp, objective, network, streams):
    j, t = mlp
    for use_plan in (False, True):
        groups_j = j["plan"] if use_plan else list(j["plan"].group_elements)
        groups_t = t["plan"] if use_plan else list(t["plan"].group_elements)
        want = jeng.search_eco(_japply, j["params"], j["xs"], j["ys"], groups_j,
                               jax.random.PRNGKey(2), objective=objective,
                               network=network, streams=streams)
        got = search_eco(_tapply, t["params"], t["xs"], t["ys"], groups_t, _key(2),
                         objective=objective, network=network, streams=streams)
        _same_result(got, want)
        assert got.nodes_visited > 0 and got.accuracy == got.baseline_accuracy
        assert any(layer.k < 64 for layer in got.config.layers)


@pytest.mark.parametrize("objective,network,choices", [
    ("bytes", None, (4, 6, 8)), ("latency", "wan", (0, 4, 6)),
    ("latency", "lan", (0, 4, 6)), ("bytes", "wan", (0, 5, 8))])
def test_exact_model_budget_equals_the_reference(mlp, objective, network, choices):
    """Same config, accuracy, counters and objective value, and the same
    candidates in the same order (``on_visit``), for both objectives and
    the WAN (culling-first) ordering."""
    j, t = mlp
    seen_j, seen_t = [], []
    kw = dict(budget=8 / 64, bit_choices=choices, max_k=16, objective=objective,
              network=network, streams=2)
    want = jeng.search_budget(_japply, j["params"], j["xs"], j["ys"], j["plan"],
                              jax.random.PRNGKey(3), on_visit=seen_j.append, **kw)
    got = search_budget(_tapply, t["params"], t["xs"], t["ys"], t["plan"], _key(3),
                        on_visit=seen_t.append, **kw)
    _same_result(got, want)
    assert [c.to_json() for c in seen_t] == [c.to_json() for c in seen_j]
    assert got.nodes_visited > 10 and got.config.meets_budget(8 / 64)
    assert teng.SearchResult.from_json(got.to_json()).to_json() == got.to_json()


def test_exact_model_budget_fallback_equals_the_reference(mlp):
    j, t = mlp
    for choices in ((0, 4), (20,), (0,)):
        kw = dict(budget=8 / 64, bit_choices=choices, acc_threshold_drop=-2.0, max_k=12)
        want = jeng.search_budget(_japply, j["params"], j["xs"], j["ys"],
                                  list(j["plan"].group_elements),
                                  jax.random.PRNGKey(9), **kw)
        got = search_budget(_tapply, t["params"], t["xs"], t["ys"],
                            list(t["plan"].group_elements), _key(9), **kw)
        _same_result(got, want)


# ---------------------------------------------------------------------------
# RESNET_SMOKE with the reference's weights
# ---------------------------------------------------------------------------

def _jafn(p, x, relu_fn=None):
    return jres.apply(p, x, JSMOKE, relu_fn=relu_fn)


def _tafn(p, x, relu_fn=None):
    return tres.apply(p, x, TSMOKE, relu_fn=relu_fn)


@pytest.fixture(scope="module")
def smoke():
    """The reference's params tree (drawn with numpy at its init scales, no
    cold jax.random compiles) in both packages, 48 images of 8x8."""
    rng = np.random.default_rng(21)
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)
                              * (2.0 / np.prod(a.shape[1:])) ** 0.5 if a.ndim == 4
                              else np.asarray(a)),
        jax.tree_util.tree_map(np.asarray, tres.init(TSMOKE, 0, "cpu")))
    tp = tres.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    xs = rng.standard_normal((48, 3, 8, 8)).astype(np.float32)
    ys = (xs[:, 0, :4, :4].mean((1, 2)) > 0).astype(np.int32)
    groups = jres.relu_group_elements(jp, JSMOKE, in_hw=8)
    assert tres.relu_group_elements(tp, TSMOKE, in_hw=8) == groups
    return (jp, jnp.asarray(xs), jnp.asarray(ys)), \
        (tp, torch.from_numpy(xs), torch.from_numpy(ys).long()), groups


def test_resnet_smoke_searches_find_the_reference_configs(smoke):
    """The same configs, accuracies and counters on a real model.  XLA's
    convolutions and torch's round differently (ulps), so a pre-activation
    on a rounding boundary could encode one LSB apart and flip a
    borderline candidate; at these weights and inputs none does, and the
    test holds them equal (a library whose rounding flips one would show
    here first)."""
    (jp, jx, jy), (tp, tx, ty), groups = smoke
    want = jeng.search_eco(_jafn, jp, jx, jy, groups, jax.random.PRNGKey(2))
    got = search_eco(_tafn, tp, tx, ty, groups, _key(2))
    assert got.config.to_json() == want.config.to_json()
    assert got.accuracy == want.accuracy
    assert got.nodes_visited == want.nodes_visited
    kw = dict(budget=8 / 64, bit_choices=(6, 8), max_k=12)
    want = jeng.search_budget(_jafn, jp, jx, jy, groups, jax.random.PRNGKey(3), **kw)
    got = search_budget(_tafn, tp, tx, ty, groups, _key(3), **kw)
    assert got.config.to_json() == want.config.to_json()
    assert got.accuracy == want.accuracy
    assert (got.nodes_visited, got.nodes_pruned) == (want.nodes_visited, want.nodes_pruned)


def test_finetune_train_step_equals_the_reference(smoke):
    """One ``train_step`` from the same params and batch, with the STE
    ReLU at (19, 13) and the same relu key: the loss and every updated
    leaf (conv weights, BatchNorm's gamma, beta, mean and var, fc) within
    1e-4 relative + 1e-5 absolute of the reference's (float32 convs round
    differently in the two packages)."""
    (jp, jx, jy), (tp, tx, ty), groups = smoke
    kms = tuple((19, 13) for _ in groups)
    jcfg = JHB(tuple(JL(k, m) for k, m in kms), tuple(groups))
    tcfg = HBConfig(tuple(HBLayer(k, m) for k, m in kms), tuple(groups))
    jo = jopt.SGD(schedule=jopt.Schedule(peak_lr=3e-3, warmup_steps=0, decay_steps=0),
                  momentum=0.9)

    def jloss(p, xb, yb, rkey):
        logits = _jafn(p, xb, relu_fn=jft.make_ste_relu(jcfg, rkey))
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.take_along_axis(logp, yb[:, None], axis=-1).mean()

    loss_j, grads = jax.jit(jax.value_and_grad(jloss))(jp, jx[:16], jy[:16],
                                                       jax.random.PRNGKey(5))
    jp2, jstate, _ = jo.update(grads, jo.init(jp), jp, jnp.zeros((), jnp.int32))
    to = topt.SGD(schedule=topt.Schedule(peak_lr=3e-3, warmup_steps=0, decay_steps=0),
                  momentum=0.9)
    tp2, tstate, step, loss_t = tft.train_step(_tafn, to, tcfg, tp, to.init(tp), 0,
                                               tx[:16], ty[:16], _key(5))
    assert step == 1
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    flat_j = jax.tree_util.tree_leaves(jp2)
    flat_t = topt.tree_leaves(tp2)
    assert len(flat_j) == len(flat_t)
    moved = 0
    for a, b, before in zip(flat_t, flat_j, topt.tree_leaves(tp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
        moved += not torch.equal(a, before)
    assert moved == len(flat_t)              # BN mean and var move too
    for a, b in zip(topt.tree_leaves(tstate["m"]),
                    jax.tree_util.tree_leaves(jstate["m"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The data pipeline and the optimizer
# ---------------------------------------------------------------------------

def test_image_pipeline_labels_exact_images_on_tolerance():
    for offset in (7,):
        want_x, want_y = JPipeline(n_classes=10, hw=8).take(24, offset)
        got_x, got_y = ImagePipeline(n_classes=10, hw=8).take(24, offset, device="cpu")
        np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
        assert got_x.dtype == torch.float32 and tuple(got_x.shape) == (24, 3, 8, 8)
        # prng.normal's tolerance, then x 1.5 and a sum
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-5, atol=5e-5)


def test_schedule_global_norm_and_sgd_equal_the_reference():
    for sched in (jopt.Schedule(), jopt.Schedule(peak_lr=3e-3, warmup_steps=0,
                                                 decay_steps=0),
                  jopt.Schedule(peak_lr=1e-2, warmup_steps=5, decay_steps=50)):
        port = topt.Schedule(**dataclasses.asdict(sched))
        for step in (0, 1, 4, 5, 30, 49, 50, 80, 20000):
            np.testing.assert_allclose(port(step), float(sched(jnp.asarray(step))),
                                       rtol=1e-6)
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": [rng.normal(size=(5,)).astype(np.float32),
                  {"c": rng.normal(size=(2, 2)).astype(np.float32)}]}
    grads = jax.tree_util.tree_map(lambda a: (a * 0.5 + 0.1).astype(np.float32), tree)
    jt, tt = (jax.tree_util.tree_map(jnp.asarray, tree),
              topt.tree_map(torch.from_numpy, tree))
    jg, tg = (jax.tree_util.tree_map(jnp.asarray, grads),
              topt.tree_map(torch.from_numpy, grads))
    np.testing.assert_allclose(float(topt.global_norm(tg)), float(jopt.global_norm(jg)),
                               rtol=1e-6)
    for max_norm in (0.5, 100.0):
        (tc, tn), (jc, jn) = topt.clip_by_global_norm(tg, max_norm), \
            jopt.clip_by_global_norm(jg, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for a, b in zip(topt.tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    for wd in (0.0, 1e-2):
        kw = dict(schedule=dict(peak_lr=0.1, warmup_steps=2, decay_steps=10),
                  momentum=0.9, weight_decay=wd)
        jo = jopt.SGD(schedule=jopt.Schedule(**kw["schedule"]), momentum=0.9,
                      weight_decay=wd)
        to = topt.SGD(schedule=topt.Schedule(**kw["schedule"]), momentum=0.9,
                      weight_decay=wd)
        jstate, tstate, jp, tp = jo.init(jt), to.init(tt), jt, tt
        for step in range(3):
            jp, jstate, jinfo = jo.update(jg, jstate, jp, jnp.asarray(step))
            tp, tstate, tinfo = to.update(tg, tstate, tp, step)
            np.testing.assert_allclose(tinfo["lr"], float(jinfo["lr"]), rtol=1e-6)
        for a, b in zip(topt.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
        assert torch.equal(tt["a"], torch.from_numpy(tree["a"]))   # inputs untouched


# ---------------------------------------------------------------------------
# The reference's search tests, on the port (tests/test_search.py)
# ---------------------------------------------------------------------------

HW = 8

@pytest.fixture(scope="module")
def setup():
    """The reference test's setup at 8x8 (it runs 16x16): a quarter of the
    simulator's elements, so these tests stay within the CPU suite's time."""
    params = tres.init(TSMOKE, 0, "cpu")
    xs = prng.normal(_key(1), (256, 3, HW, HW))
    ys = (xs[:, 0, :HW // 2, :HW // 2].mean((1, 2)) > 0).long()

    def afn(p, x, relu_fn=None):
        return tres.apply(p, x, TSMOKE, relu_fn=relu_fn)

    groups = tres.relu_group_elements(params, TSMOKE, in_hw=HW)
    params, _ = tft.finetune(afn, params, xs[:192], ys[:192], HBConfig.exact(groups),
                             _key(5), epochs=4, batch=64, lr=3e-3)
    return afn, params, xs[192:], ys[192:], groups


def test_eco_is_zero_error(setup):
    afn, params, xs, ys, groups = setup
    res = search_eco(afn, params, xs, ys, groups, _key(2))
    assert res.accuracy == res.baseline_accuracy
    assert res.budget_fraction < 0.40
    assert all(layer.m == 0 for layer in res.config.layers)


def test_budget_search_respects_budget(setup):
    """(The searches below run on 32 images up to k = 16, 12 or 10, the
    reference's on 64 up to 28 or 12: the suite's time.)"""
    afn, params, xs, ys, groups = setup
    res = search_budget(afn, params, xs[:32], ys[:32], groups, _key(3), budget=8 / 64,
                        bit_choices=(5, 6, 8), max_k=12)
    assert res.config.meets_budget(8 / 64)
    assert res.accuracy >= res.baseline_accuracy - 0.10
    assert res.nodes_visited > 0


def test_budget_search_accepts_plan_and_can_cull(setup):
    afn, params, xs, ys, groups = setup
    plan = tapi.trace_plan(afn, params, (4, 3, HW, HW))
    assert list(plan.group_elements) == [g * 4 for g in groups]
    res = search_budget(afn, params, xs[:32], ys[:32], plan, _key(7), budget=6 / 64,
                        bit_choices=(0, 5, 6), max_k=16)
    assert res.plan is not None and res.plan.hb == res.config
    assert res.config.meets_budget(6 / 64)
    for layer in res.config.layers:
        assert layer.width == 0 or layer.width in (5, 6)


def test_eco_search_accepts_plan(setup):
    afn, params, xs, ys, groups = setup
    plan = tapi.trace_plan(afn, params, (2, 3, HW, HW))
    res = search_eco(afn, params, xs, ys, plan, _key(8))
    assert res.plan is not None and res.plan.hb == res.config
    assert res.plan.cost().bytes_tx > 0


def test_budget_fallback_respects_max_k(setup):
    afn, params, xs, ys, groups = setup
    kw = dict(budget=8 / 64, acc_threshold_drop=-2.0, max_k=16)
    res = search_budget(afn, params, xs, ys, groups, _key(9), bit_choices=(0, 4), **kw)
    assert all(layer.k <= 16 and layer.width == 4 for layer in res.config.layers)
    res = search_budget(afn, params, xs, ys, groups, _key(9), bit_choices=(20,), **kw)
    assert all(layer.k <= 16 for layer in res.config.layers)
    res = search_budget(afn, params, xs, ys, groups, _key(9), bit_choices=(0,), **kw)
    assert all(layer.is_identity for layer in res.config.layers)


def test_latency_objective_never_worse_on_estimate(setup):
    afn, params, xs, ys, groups = setup
    plan = tapi.trace_plan(afn, params, (2, 3, HW, HW))
    kw = dict(budget=8 / 64, bit_choices=(0, 5, 6), max_k=10)
    res_b = search_budget(afn, params, xs[:32], ys[:32], plan, _key(11), **kw)
    res_l = search_budget(afn, params, xs[:32], ys[:32], plan, _key(11),
                          objective="latency", network=tapi.WAN, **kw)
    assert (res_b.objective, res_l.objective) == ("bytes", "latency")
    est_l = res_l.plan.estimate(network=tapi.WAN)
    assert est_l <= res_b.plan.estimate(network=tapi.WAN)
    assert res_l.objective_value == est_l
    assert res_b.objective_value == float(res_b.plan.cost().bytes_tx)
    assert res_l.config.meets_budget(8 / 64)


def test_eco_reports_objective_value(setup):
    afn, params, xs, ys, groups = setup
    plan = tapi.trace_plan(afn, params, (2, 3, HW, HW))
    res = search_eco(afn, params, xs[:32], ys[:32], plan, _key(12),
                     objective="latency", network="wan")
    assert res.objective == "latency"
    assert res.objective_value == res.plan.estimate(network=tapi.WAN)
    back = teng.SearchResult.from_json(res.to_json())
    assert (back.objective, back.objective_value) == ("latency", res.objective_value)
    cone_plan = dataclasses.replace(plan, cone=True)
    res_c = search_eco(afn, params, xs[:32], ys[:32], cone_plan, _key(12),
                       objective="latency", network="wan")
    assert res_c.plan.cone
    assert res_c.objective_value == res_c.plan.estimate(network=tapi.WAN)
    assert res_c.objective_value < res.objective_value


def test_finetune_runs_and_preserves_shapes(setup):
    afn, params, xs, ys, groups = setup
    cfg = HBConfig(tuple(HBLayer(k=19, m=13) for _ in groups), tuple(groups))
    p2, losses = tft.finetune(afn, params, xs, ys, cfg, _key(4), epochs=1, batch=32,
                              lr=1e-3)
    assert len(losses) > 0 and np.isfinite(losses).all()
    assert [a.shape for a in topt.tree_leaves(p2)] == \
        [a.shape for a in topt.tree_leaves(params)]


def test_ordered_bit_choices_wan_puts_culling_first():
    assert teng._ordered_bit_choices((0, 5, 6), "latency", tapi.WAN) == [0, 5, 6]
    assert teng._ordered_bit_choices((6, 0, 5), "latency", tapi.WAN) == [0, 5, 6]
    assert teng._ordered_bit_choices((0, 5, 6), "latency", tapi.LAN) == [6, 5, 0]
    assert teng._ordered_bit_choices((0, 5, 6), "bytes", tapi.WAN) == [6, 5, 0]


def test_wan_latency_search_visits_culled_before_dense(setup):
    afn, params, xs, ys, groups = setup

    def run(**kw):
        visited = []
        search_budget(afn, params, xs[:32], ys[:32], groups, _key(13), budget=8 / 64,
                      bit_choices=(0, 5, 6), max_k=10, on_visit=visited.append, **kw)
        return visited

    wan = run(objective="latency", network="wan")
    has_cull = [any(layer.width == 0 for layer in c.layers) for c in wan]
    dense = [all(layer.width > 0 for layer in c.layers) for c in wan]
    assert has_cull[0] and has_cull.index(True) < dense.index(True)
    assert all(layer.width > 0 for layer in run(objective="latency", network="lan")[0].layers)
    assert all(layer.width > 0 for layer in run()[0].layers)


def test_search_restores_the_callers_float_settings():
    """The searches run deterministic convolutions with TF32 off and give
    the caller's settings back."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    cudnn.benchmark, cudnn.allow_tf32 = True, True
    seen = []

    def afn(p, x, relu_fn=None):
        seen.append((cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return _tapply(p, x, relu_fn)

    try:
        p = {k: torch.from_numpy(v) for k, v in _mlp_params().items()}
        xs = torch.zeros((4, 8))
        search_eco(afn, p, xs, torch.zeros(4, dtype=torch.long), [12, 12], _key(0))
        assert seen and all(s == (True, False, False, False) for s in seen)
        assert (cudnn.benchmark, cudnn.allow_tf32) == (True, True)
    finally:
        (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
