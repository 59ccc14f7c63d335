"""The port's two-party device execution, against the reference.

Mirrors the reference's ``tests/test_mesh_serving.py`` and
``tests/test_launch_mpc.py`` and adds the data-axis cases of
``tests/test_engine.py``:

- mesh sizing (``launch.mesh``) and the smoke meshes' axis names;
- ``MeshComm`` on the smoke mesh (party axis of size 1: the local flip)
  against ``SimComm``: swap, ``party_is``, ``party_slice``, a coalesced
  flush, the rejection of an indivisible axis;
- the smoke-mesh ``serve_step`` / ``jit_step`` (with and without the data
  axis) bit-identical to the reference's ``serve_step()`` on RESNET_SMOKE,
  its census (generator loop) or its replayed counters (captured replay)
  equal to ``model.schedule()``; the pool-less and axis-less rejections;
  ``mpc_serving_mesh`` without a process group;
- the data-axis triple shards (``shard_relu_triples``, ``shard_pool``,
  ``TriplePool.shard``) bit-identical to the reference's, and
  ``pool_party_specs`` at the reference's ``PartitionSpec`` positions,
  which ``slice_party_bundle`` reads;
- real meshes of gloo ranks, each its own OS process on the CPU: two ranks
  (party axis 2) run the reference's multi-group ``relu_many`` (cone off
  and on) and the smoke ResNet step, four ranks the (2, 2) data-axis mesh.
  Every rank's census must equal ``schedule.simulate`` /
  ``model.schedule()`` round for round (the per-shard plan's on the data
  axis), its gathered shares the reference's ``SimComm`` run's bit for bit
  (per shard: the reference's model on that shard's rows with
  ``TriplePool.shard``'s pool), and the data axis's reveal the reference's
  unsharded call's within the reference's tolerance, 2^(13-16) + 1e-4.
  The port's own ``SimComm`` runs are held beside them.

The meshes' ranks (``torch_mesh_ranks.py``, started by
``launch.mesh.spawn_local``: the ``spawn`` start method, the mesh built by
``mpc_serving_mesh``) start with the ``meshes`` fixture and run while the
reference takes its compiles.  The reference's RESNET_SMOKE runs go
through its captured-replay loop (``HB_ROUND_LOOP=scan``: one compile per
signature, which its own tests hold bit-identical to its generator loop).
Ranks meet through a ``file://`` store in a temporary directory (no fixed
TCP port), run one torch thread each, and every wait on them is bounded.
"""
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import RESNET_SMOKE as RESNET_SMOKE_J
from repro.core import beaver as jbeaver, comm as jcomm, gmw as jgmw, ring as jring
from repro.launch.mesh import make_mpc_smoke_mesh as jmake_mpc_smoke_mesh
from repro_torch import api
from repro_torch.configs import RESNET_SMOKE
from repro_torch.core import beaver, comm as comm_lib, fixed, gmw, prng, ring, \
    schedule, shares
from repro_torch.core.mpc_tensor import MPCTensor
from repro_torch.launch import serve as serve_lib
from repro_torch.launch.mesh import (Mesh, make_mpc_smoke_mesh, make_smoke_mesh,
                                     mpc_mesh_shape, mpc_serving_mesh, spawn_local)

from test_torch_transport import _jbundle, _jmpc, _smoke, _tmpc

RANKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mesh_ranks.py")
RANK_WAIT_S = 120.0          # every wait on a mesh's ranks
RELU_SPECS = ((256, 64, 0), (256, 21, 13), (128, 21, 13), (128, 20, 14))
DATA_BATCH = 4               # the (2, 2) mesh's global batch: 2 rows a shard


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _env:
    """``os.environ[name] = value`` inside the block."""

    def __init__(self, name, value):
        self.name, self.value = name, value

    def __enter__(self):
        self.prev = os.environ.get(self.name)
        os.environ[self.name] = self.value

    def __exit__(self, *exc):
        if self.prev is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.prev


def _round_loop(mode):
    return _env("HB_ROUND_LOOP", mode)


def _smoke_model(s, batch=2):
    """The port's smoke model of ``s`` (``test_torch_transport._smoke``),
    its plan traced at ``batch``."""
    plan = api.trace_plan(s["afn"], s["params"], (batch, 3, 8, 8), hb=s["plan"].hb,
                          name="smoke")
    return api.compile(s["afn"], s["params"], RESNET_SMOKE, plan,
                       api.Session(key=0, device="cpu"))


def _relu_inputs():
    """The reference's multi-group ``relu_many`` inputs (``_TWO_PARTY_SCRIPT``),
    dense and cone triples."""
    rng = np.random.default_rng(0)
    keys = [prng.PRNGKey(40 + i, "cpu") for i in range(len(RELU_SPECS))]
    xs = [shares.share(prng.PRNGKey(50 + i, "cpu"), fixed.encode(torch.from_numpy(
        rng.uniform(-3.5, 3.5, n).astype(np.float32))))
        for i, (n, _, _) in enumerate(RELU_SPECS)]
    trs = {cone: [beaver.gen_relu_triples(prng.PRNGKey(60 + i, "cpu"), n, k - m,
                                          cone=cone)
                  for i, (n, k, m) in enumerate(RELU_SPECS)]
           for cone in (False, True)}
    return keys, xs, trs


def _jrelu(xs, trs, cone):
    """The reference's ``relu_many`` on ``SimComm`` over the jax copies of
    ``_relu_inputs``' shares and triples, as port shares: one ``jax.jit``
    program, compiled at XLA's optimisation level 0 (a third of its eager
    run's compiles; the same shares)."""
    keys = [jax.random.PRNGKey(40 + i) for i in range(len(RELU_SPECS))]
    kms = [(k, m) for _, k, m in RELU_SPECS]
    jxs = [jring.Ring64(*map(jax.numpy.asarray, ring.to_limbs(x))) for x in xs]
    jtrs = [_jbundle(t) for t in trs[cone]]
    run = jax.jit(lambda v, t: jgmw.relu_many(keys, v, t, jcomm.SimComm(), kms,
                                               cone=cone))
    outs = run.lower(jxs, jtrs).compile(
        compiler_options={"xla_backend_optimization_level": "0"})(jxs, jtrs)
    return [ring.from_limbs(np.asarray(o.lo), np.asarray(o.hi), "cpu") for o in outs]


def _jmodel_run(s, jplan, X, provider):
    """The reference's model of ``s``'s weights under ``jplan`` on the
    share tensor of ``X`` (key 4, ``SimComm``), drawing from the reference
    pool ``provider``, on its captured-replay loop; as port shares.  That
    loop's XLA optimisation is capped (``HB_XLA_OPT=0``), as
    ``test_torch_loop`` caps it: on RESNET_SMOKE the reference's replay
    compiled at the default level gives other shares than its generator
    loop, and at level 0 the same, bit for bit."""
    with _round_loop("scan"), _env("HB_XLA_OPT", "0"):
        model = japi.compile(s["jafn"], s["jparams"], RESNET_SMOKE_J, jplan,
                             japi.Session(key=0, provider=provider))
        return _tmpc(model(_jmpc(X.data, X.frac_bits), key=jax.random.PRNGKey(4))).data


class _Ranks:
    """One mesh's ranks (``torch_mesh_ranks.run`` on the inputs saved under
    ``tmp``), run by ``spawn_local`` on a thread of this process, so the
    test process works meanwhile; ``results()`` waits."""

    def __init__(self, tmp, name: str, world: int, job: dict):
        inputs = tmp / f"{name}.pt"
        torch.save(job, inputs)
        self._out, self._err = None, None
        self._thread = threading.Thread(target=self._spawn, args=(world, inputs),
                                        daemon=True)
        self._thread.start()

    def _spawn(self, world, inputs):
        try:
            self._out = spawn_local(RANKS, "run", world, args=(str(inputs),),
                                    timeout_s=RANK_WAIT_S)
        except BaseException as e:      # noqa: BLE001 (re-raised in results())
            self._err = e

    def results(self):
        self._thread.join(RANK_WAIT_S + 30)
        assert not self._thread.is_alive(), "mesh ranks still running"
        if self._err is not None:
            raise self._err
        return self._out


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """The port's smoke inputs, the (2, 1) and (2, 2) meshes' ranks started
    on them, and, made while the ranks run, the reference's ``SimComm``
    runs: the smoke ResNet at batch 2, the multi-group ``relu_many`` (cone
    off and on), and the (2, 2) mesh's input at batch 4 whole and per data
    shard (its rows, the plan at batch 2, ``TriplePool.shard``'s pool)."""
    s = _smoke()
    tmp = tmp_path_factory.mktemp("mesh")
    key = prng.PRNGKey(4, "cpu")
    keys, xs, trs = _relu_inputs()
    two = _Ranks(tmp, "two", 2, {
        "relu": (keys, xs, trs), "relu_specs": RELU_SPECS, "data_axis": None,
        "model": (s["plan"], s["params"], s["X"].data, s["pool"], key)})
    gen = torch.Generator().manual_seed(9)
    x4 = torch.rand((DATA_BATCH, 3, 8, 8), generator=gen) * 2 - 1
    X4 = MPCTensor.from_plain(prng.PRNGKey(12, "cpu"), x4)
    model4 = _smoke_model(s, DATA_BATCH)
    pool4 = beaver.gen_plan_triples(prng.PRNGKey(13, "cpu"), model4.plan.triple_specs())
    four = _Ranks(tmp, "four", 4, {
        "data_axis": "data",
        "model": (model4.plan, s["params"], X4.data, pool4, key)})
    want = _jmodel_run(s, s["jplan"], s["X"], jbeaver.TriplePool(s["jpool"]))
    jrelu = {cone: _jrelu(xs, trs, cone) for cone in (False, True)}
    jpool4 = [_jbundle(b) for b in pool4]
    per = DATA_BATCH // 2
    jshards = [_jmodel_run(s, s["jplan"],
                           MPCTensor(X4.data[:, d * per:(d + 1) * per], X4.frac_bits),
                           jbeaver.TriplePool(jpool4).shard(d, 2)) for d in range(2)]
    jplan4 = japi.Plan.from_json(json.loads(json.dumps(model4.plan.to_json())))
    jwant4 = _jmodel_run(s, jplan4, X4, jbeaver.TriplePool(jpool4))
    s.update(want=want, key=key, relu=(keys, xs, trs), jrelu=jrelu, two=two, four=four,
             data=(model4, X4, pool4), jdata=(jshards, jwant4))
    yield s
    for ranks in (two, four):
        ranks.results()


# ---------------------------------------------------------------------------
# mesh sizing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,shape", [(512, (2, 256)), (8, (2, 4)), (2, (2, 1)),
                                     (7, (2, 3))])
def test_mpc_mesh_shape_derives_data_axis_from_devices(n, shape):
    assert mpc_mesh_shape(n) == shape


def test_mpc_mesh_shape_rejects_single_device():
    with pytest.raises(ValueError, match="make_mpc_smoke_mesh"):
        mpc_mesh_shape(1)


def test_smoke_meshes_have_serving_axis_names():
    mpc = make_mpc_smoke_mesh("cpu")
    assert mpc.axis_names == jmake_mpc_smoke_mesh().axis_names == ("party", "data")
    assert mpc.size == 1 and mpc.coords == {"party": 0, "data": 0}
    assert make_smoke_mesh("cpu").axis_names == ("data", "model")
    with pytest.raises(ValueError, match="backend"):
        Mesh((2, 1), ("party", "data"), device="cpu")


# ---------------------------------------------------------------------------
# MeshComm on the smoke mesh against SimComm
# ---------------------------------------------------------------------------

def _words(seed, *shape):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=g,
                         dtype=torch.int64).to(torch.int32)


def test_meshcomm_swap_matches_simcomm_on_smoke_mesh():
    x = _words(0, 2, 3, 5)
    mc = comm_lib.MeshComm("party", 1)
    assert torch.equal(mc.swap(x), comm_lib.SimComm().swap(x))
    ring_x = _words(1, 2, 4).to(torch.int64) << 20
    assert torch.equal(mc.swap(ring_x), comm_lib.SimComm().swap(ring_x))
    assert [(c.count, c.bytes) for c in mc.census] == [(1, 60), (1, 32)]


def test_meshcomm_party_is_and_slice_match_simcomm_on_smoke_mesh():
    x = _words(2, 2, 4)
    mc, sim = comm_lib.MeshComm("party", 1), comm_lib.SimComm()
    for p in (0, 1):
        assert torch.equal(torch.broadcast_to(mc.party_is(p, x), x.shape),
                           torch.broadcast_to(sim.party_is(p, x), x.shape))
    assert torch.equal(mc.party_slice(x), sim.party_slice(x))


def test_coalescing_flush_over_meshcomm_bit_identical_to_sim():
    """One flattened flush over the mesh base hands every enqueuer back
    exactly the payload the sim base would have: one census entry."""
    payloads = [_words(3, 2, 7), _words(4, 2, 3, 5),
                _words(5, 2, 11).to(torch.int64) << 17]

    def run(base):
        cc = comm_lib.CoalescingComm(base)
        handles = [cc.enqueue(p) for p in payloads]
        opened = cc.flush()
        return [opened[h] for h in handles], cc

    want, _ = run(comm_lib.SimComm())
    got, cc = run(comm_lib.MeshComm("party", 1))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert [(c.count, c.bytes) for c in cc.base.census] == [(1, cc.round_bytes[0])]
    assert cc.round_bytes == [4 * (7 + 15 + 22)]


def test_smoke_mesh_takes_the_captured_replay_and_a_party_axis_does_not():
    """``CoalescingComm`` over a smoke-mesh ``MeshComm`` (local flips) may
    run as the captured replay; over a party axis of size 2 (a process
    group's exchanges) it runs the generator loop."""
    from types import SimpleNamespace
    from repro_torch.runtime import loop as loop_lib

    smoke = comm_lib.CoalescingComm(comm_lib.MeshComm("party", 1))
    two = comm_lib.CoalescingComm(comm_lib.MeshComm(
        "party", 2, mesh=SimpleNamespace(coords={"party": 1})))
    assert loop_lib.compiled_eligible(smoke)
    assert not loop_lib.compiled_eligible(two)
    assert not loop_lib.compiled_eligible(comm_lib.MeshComm("party", 1))
    assert two.base.party == 1 and two.base.local_parties == 1
    x = _words(6, 2, 3)
    assert torch.equal(two.base.party_slice(x), x[1:])
    assert torch.equal(two.base.party_is(1, x), torch.ones((1, 1), dtype=torch.bool))
    with pytest.raises(ValueError, match="needs its mesh"):
        comm_lib.MeshComm("party", 2)


def test_meshcomm_rejects_indivisible_axis():
    with pytest.raises(ValueError, match="divide"):
        comm_lib.MeshComm("party", 3)
    with pytest.raises(ValueError, match="divide"):
        jcomm.MeshComm("party", 3)


# ---------------------------------------------------------------------------
# the mesh-native step on the smoke mesh
# ---------------------------------------------------------------------------

def _census(step):
    return [(c.count, c.bytes) for c in step.census]


def _check_smoke_counts(step, loop, sched):
    """On the generator loop every fused round is one exchange handed to
    the ``MeshComm``: its census is the schedule.  On the captured replay
    the graph holds the flips (the census stays empty) and the replayed
    counters are the schedule."""
    assert step.comm.n_rounds == sched.n_rounds
    assert step.comm.round_bytes == list(sched.round_bytes)
    assert _census(step) == ([(1, b) for b in sched.round_bytes] if loop == "python"
                             else [])


@pytest.mark.parametrize("loop", ["python", "scan"])
@pytest.mark.parametrize("data_axis", [None, "data"])
def test_mesh_serve_step_bit_identical_to_reference_on_smoke_mesh(meshes, loop,
                                                                  data_axis):
    """``jit_step(smoke mesh)``, on either round loop and with or without
    the data axis (``shard_pool(pool, 1)``), equals ``serve_step(None)``
    and the reference's ``SimComm`` run bit for bit; its census (generator
    loop) or its replayed counters (captured replay) are the schedule,
    round for round."""
    s = meshes
    model = _smoke_model(s)
    sched = model.schedule()
    pool = s["pool"] if data_axis is None else beaver.shard_pool(s["pool"], 1)
    with _round_loop(loop):
        sim = model.serve_step()(s["params"], s["X"].data, s["pool"], s["key"])
        step = model.jit_step(make_mpc_smoke_mesh("cpu"), data_axis=data_axis)
        for _ in range(2):
            got = step(s["params"], s["X"].data, pool, s["key"])
            assert torch.equal(got, sim) and torch.equal(got, s["want"])
            _check_smoke_counts(step, loop, sched)


def test_mesh_serve_step_requires_triple_pool(meshes):
    step = _smoke_model(meshes).serve_step(make_mpc_smoke_mesh("cpu"))
    with pytest.raises(ValueError, match="triple pool"):
        step(meshes["params"], meshes["X"].data, None, meshes["key"])


@pytest.mark.parametrize("entry", ["serve_step", "jit_step"])
def test_mesh_serve_step_rejects_axis_free_meshes(meshes, entry):
    model = _smoke_model(meshes)
    make = getattr(model, entry)
    with pytest.raises(ValueError, match="party"):
        make(make_smoke_mesh("cpu"))
    with pytest.raises(ValueError, match="'batch'"):
        make(make_mpc_smoke_mesh("cpu"), data_axis="batch")


def test_make_mpc_serve_step_on_smoke_mesh(meshes):
    """``launch.serve.make_mpc_serve_step``'s mesh step, on a plan of the
    smoke model's own groups, equals the compiled model's."""
    s = meshes
    hb = s["plan"].hb
    step = serve_lib.make_mpc_serve_step(RESNET_SMOKE, hb, mesh=make_mpc_smoke_mesh("cpu"),
                                         device="cpu")
    with _round_loop("python"):
        got = step(s["params"], s["X"].data, s["pool"], s["key"])
    assert torch.equal(got, s["want"])
    _check_smoke_counts(step, "python", _smoke_model(s).schedule())


def test_mpc_serving_mesh_without_a_process_group_is_the_smoke_mesh(monkeypatch):
    """With no process group and no ``WORLD_SIZE`` (or one of 1), the
    serving mesh is the one-process smoke mesh; the two- and four-rank
    meshes below are built by ``mpc_serving_mesh`` in every rank."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for world in (None, "1"):
        if world is not None:
            monkeypatch.setenv("WORLD_SIZE", world)
        mesh = mpc_serving_mesh(backend="gloo", device="cpu")
        assert mesh.shape == {"party": 1, "data": 1} and mesh.backend is None
        assert mesh.axis_names == ("party", "data") and mesh.groups == {}


# ---------------------------------------------------------------------------
# the data-axis triple shards and the party positions, against the reference
# ---------------------------------------------------------------------------

def _same_bundle(port, ref):
    """A port bundle equal, leaf for leaf, to a reference bundle."""
    if port is None or ref is None:
        assert port is None and ref is None
        return
    got, want = (jax.tree_util.tree_leaves(b) for b in (_jbundle(port), ref))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _members(b):
    levels = b.bin_levels if isinstance(b.bin_levels, tuple) else (b.bin_levels,)
    return (b.bin_init, *levels, b.b2a, b.mult)


def _spec_pairs(spec, jspec):
    """(port spec, reference PartitionSpec) of every member field (an
    arithmetic field's two limbs each)."""
    for m, jm in zip(_members(spec), _members(jspec), strict=True):
        for f in ("a", "b", "c"):
            for leaf in jax.tree_util.tree_leaves(
                    getattr(jm, f), is_leaf=lambda v: isinstance(
                        v, jax.sharding.PartitionSpec)):
                yield getattr(m, f), leaf


@pytest.mark.parametrize("E,S,cone", [(96, 3, False), (40, 2, False), (96, 3, True),
                                      (40, 2, True)])
def test_shard_relu_triples_bit_identical_to_reference(E, S, cone):
    b = beaver.gen_relu_triples(prng.PRNGKey(E, "cpu"), E, 8, cone=cone)
    jb = _jbundle(b)
    for i in range(S):
        shard = beaver.shard_relu_triples(b, i, S)
        _same_bundle(shard, jbeaver.shard_relu_triples(jb, i, S))
        assert all(t.is_contiguous() for t in beaver.relu_tensors(shard))
    with pytest.raises(ValueError, match="divisible"):
        beaver.shard_relu_triples(b, 0, E + 1)


@pytest.mark.parametrize("cone", [False, True])
def test_shard_pool_and_triple_pool_shard_bit_identical_to_reference(cone):
    specs = [(64, 8), (0, 8), (40, 0), (40, 8)]
    pool = beaver.gen_plan_triples(prng.PRNGKey(0, "cpu"), specs, cone=cone)
    jpool = [_jbundle(b) for b in pool]
    for got, want in zip(beaver.shard_pool(pool, 2), jbeaver.shard_pool(jpool, 2)):
        _same_bundle(got, want)
    base, jbase = beaver.TriplePool(pool), jbeaver.TriplePool(jpool)
    base.relu_triples(64, 8, cone=cone)
    jbase.relu_triples(64, 8, cone=cone)
    for i in range(2):
        shard, jshard = base.shard(i, 2), jbase.shard(i, 2)
        for n, w in specs[1:]:
            _same_bundle(shard.relu_triples(n // 2, w, cone=cone),
                         jshard.relu_triples(n // 2, w, cone=cone))
    assert base.consumed == 1          # the base pool is left as it was


@pytest.mark.parametrize("data_axis", [None, "data"])
@pytest.mark.parametrize("cone", [False, True])
def test_pool_party_specs_at_reference_positions(cone, data_axis):
    """Each leaf's partition is the reference's ``PartitionSpec``, entry for
    entry; ``slice_party_bundle`` keeps exactly the party rows there."""
    pool = beaver.gen_plan_triples(prng.PRNGKey(1, "cpu"), [(64, 8), (0, 8), (32, 5)],
                                   cone=cone)
    if data_axis is not None:
        pool = beaver.shard_pool(pool, 2)
    jpool = [_jbundle(b) for b in pool]
    specs = beaver.pool_party_specs(pool, "party", data_axis=data_axis)
    jspecs = jbeaver.pool_party_specs(jpool, "party", data_axis=data_axis)
    checked = 0
    for b, sp, jsp in zip(pool, specs, jspecs):
        if b is None:
            assert sp is None and jsp is None
            continue
        for got, want in _spec_pairs(sp, jsp):
            assert got == tuple(want)
            checked += 1
        if data_axis is None:
            for party in (0, 1):
                sliced = beaver.slice_party_bundle(b, party)
                for leaf, part, spec in zip(beaver.relu_tensors(b),
                                            beaver.relu_tensors(sliced),
                                            beaver.relu_tensors(sp), strict=True):
                    d = spec.index("party")
                    assert torch.equal(part, leaf.narrow(d, party, 1))
    assert checked > 0


# ---------------------------------------------------------------------------
# real meshes: gloo ranks as OS processes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cone", [False, True])
def test_two_party_relu_many_census_matches_schedule_and_sim(meshes, cone):
    """Two ranks (party axis 2, the mesh ``mpc_serving_mesh`` built): the
    multi-group ``relu_many`` makes one exchange per fused round, with the
    schedule's bytes, and its gathered shares are the reference's
    ``SimComm`` run's bit for bit (and the port's)."""
    keys, xs, trs = meshes["relu"]
    sched = schedule.simulate([(n, k - m, (n, k, m)) for n, k, m in RELU_SPECS],
                              cone=cone)
    want = meshes["jrelu"][cone]
    sim = gmw.relu_many(keys, xs, trs[cone], comm_lib.SimComm(),
                        [(k, m) for _, k, m in RELU_SPECS], cone=cone)
    results = meshes["two"].results()
    assert [(r["shape"], r["coords"]) for r in results] == [
        ({"party": 2, "data": 1}, {"party": p, "data": 0}) for p in (0, 1)]
    for r in results:
        census, gathered = r[("relu", cone)]
        assert census == [(1, b) for b in sched.round_bytes]
    assert len(results[0][("relu", cone)][1]) == len(want) == len(RELU_SPECS)
    for got, w, p in zip(results[0][("relu", cone)][1], want, sim):
        assert torch.equal(got, w) and torch.equal(got, p)
    assert results[1][("relu", cone)][1] == [None] * len(want)


def test_two_party_resnet_step_census_matches_schedule_and_reference(meshes):
    """Two ranks run the smoke ResNet's ``jit_step(mesh)``: each rank's
    census equals ``model.schedule()`` round for round, each holds its own
    party's rows of the reference's output, and rank 0's gather is it."""
    s = meshes
    sched = _smoke_model(s).schedule()
    results = s["two"].results()
    for party, r in enumerate(results):
        census, block, _ = r["step"]
        assert census == [(1, b) for b in sched.round_bytes]
        assert torch.equal(block, s["want"][party:party + 1])
    assert torch.equal(results[0]["step"][2], s["want"])


def test_data_axis_census_and_shares_per_shard(meshes):
    """The (2, 2) mesh on four ranks: each shard's census is the schedule
    of the plan traced at its batch (rounds unchanged, bytes halved), its
    shares the reference's ``SimComm`` model's on its rows with
    ``TriplePool.shard``'s pool (and the port's ``SimComm`` step's), and
    the gathered reveal the reference's unsharded call's within the
    reference's tolerance."""
    s = meshes
    model4, X4, pool4 = s["data"]
    jshards, jwant4 = s["jdata"]
    shard_sched = _smoke_model(s, DATA_BATCH // 2).schedule()
    full_sched = model4.schedule()
    assert shard_sched.n_rounds == full_sched.n_rounds
    assert 2 * shard_sched.bytes_tx == full_sched.bytes_tx
    results = s["four"].results()
    per = DATA_BATCH // 2
    assert [r["shape"] for r in results] == [{"party": 2, "data": 2}] * 4
    assert sorted((r["coords"]["party"], r["coords"]["data"]) for r in results) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in results:
        census, block, _ = r["step"]
        assert census == [(1, b) for b in shard_sched.round_bytes]
        p, d = r["coords"]["party"], r["coords"]["data"]
        assert torch.equal(block, jshards[d][p:p + 1])
        shard = api.compile(s["afn"], s["params"], RESNET_SMOKE, model4.plan,
                            api.Session(key=0, device="cpu",
                                        provider=beaver.TriplePool(pool4).shard(d, 2)))
        sim = shard.serve_step()(s["params"], X4.data[:, d * per:(d + 1) * per], None,
                                 s["key"])
        assert torch.equal(block, sim[p:p + 1])
    gathered = results[0]["step"][2]
    assert gathered.shape == jwant4.shape == (2, DATA_BATCH, 10)
    assert torch.equal(gathered, torch.cat(jshards, dim=1))
    assert torch.equal(model4.serve_step()(s["params"], X4.data, pool4, s["key"]), jwant4)
    np.testing.assert_allclose(fixed.decode_np(gathered[0] + gathered[1]),
                               fixed.decode_np(jwant4[0] + jwant4[1]),
                               atol=2 ** (13 - 16) + 1e-4)
