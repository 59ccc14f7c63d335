"""The port's serving engine, its pump and the HTTP frontend, against the
reference engine and the port's serial oracle.

Mirrors the reference's ``tests/test_engine.py`` (the canonical mix,
reordered submissions, seeded random mixes, the policy, pow2 bucketing,
culled and unservable plans, the plan cache, tenancy, deadline shedding,
result timeouts, typed errors, the api re-export) and
``tests/test_frontend.py`` (pump progress, pump timeout, manual
poll/flush, the HTTP round trip).  Where a case's inputs go through the
reference engine too, that engine runs once, in a module fixture, and the
port's output shares must equal its shares bit for bit; cases whose
contract is the port's own behaviour (the pump, timeouts, budgets, errors,
HTTP) are held against the port's serial oracle.  Batch retry is held with
a comm wrapper, local to this file, that raises a retryable
``CommTimeout`` once.  Every wait on a thread, a future or a socket has
its own timeout (a future of an engine driven by hand resolves in the
caller's thread: ``result()`` flushes)."""
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from repro import api as japi, serve as jserve
from repro.core import mpc_tensor as jmpc, ring as jring
from repro_torch import api as tapi, errors, serve
from repro_torch.core import beaver, comm as tcomm, faults, mpc_tensor as tmpc, \
    prng, ring as tring, schedule
from repro_torch.serve import BatchPolicy, InferenceEngine

D_IN, D_HID, D_OUT = 6, 5, 4
WAIT_S = 60.0            # every wait on a thread, future or socket
SEEDS = (0, 1, 2)
HOST = "127.0.0.1"



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are many small integer ops: on one thread
    they run as fast, and do not crowd the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

class JTinyCfg:
    name = "tiny-mlp"


class TTinyCfg:
    name = "tiny-mlp"


def _japply(params, x, relu_fn=None):
    rf = relu_fn if relu_fn is not None else (lambda v, g: jax.nn.relu(v))
    return rf(rf(x @ params["w1"], 0) @ params["w2"], 1)


def _tapply(params, x, relu_fn=None):
    rf = relu_fn if relu_fn is not None else (lambda v, g: torch.relu(v))
    return rf(rf(x @ params["w1"], 0) @ params["w2"], 1)


def _tiny_forward(params, hs, cfg, relu_fn, comm):
    hs = relu_fn([h.matmul_public(params["w1"]) for h in hs], 0)
    return relu_fn([h.matmul_public(params["w2"]) for h in hs], 1)


japi.register_mpc_forward(JTinyCfg, _tiny_forward)
tapi.register_mpc_forward(TTinyCfg, _tiny_forward)

_W = {name: (np.random.default_rng(seed).standard_normal(shape) * 0.4).astype(np.float32)
      for name, seed, shape in (("w1", 0, (D_IN, D_HID)), ("w2", 1, (D_HID, D_OUT)))}
TPARAMS = {k: torch.from_numpy(v) for k, v in _W.items()}
TPLAN = tapi.trace_plan(_tapply, TPARAMS, (2, D_IN), name="tiny")
TPLAN = TPLAN.with_hb(tapi.HBConfig((tapi.HBLayer(k=21, m=13),) * 2,
                                    TPLAN.group_elements))


def _x(i: int, batch: int) -> np.ndarray:
    return np.random.default_rng(100 + i).standard_normal((batch, D_IN)).astype(np.float32)


def _engine(plan=TPLAN, policy=None, session=None, apply_fn=_tapply, **kw):
    return InferenceEngine(apply_fn, TPARAMS, TTinyCfg(), plan,
                           session or tapi.Session(key=0, device="cpu"),
                           policy=policy, **kw)


def _serial_oracle(x, request_id: int, plan=TPLAN):
    """Serial per-request execution on the same shares and triples: one
    stream, the request's key ``request_key(id)`` (less the split the
    engine's encryption takes), a fresh inline provider, auto-batching
    off (``test_engine.py``'s ``_serial_oracle``)."""
    session = tapi.Session(key=0, device="cpu")
    model = tapi.compile(_tapply, TPARAMS, TTinyCfg(), plan, session)
    key = session.request_key(request_id)
    if not isinstance(x, tmpc.MPCTensor):
        enc_key, key = prng.split(key)
        x = tmpc.MPCTensor.from_plain(enc_key, torch.as_tensor(x))
    return model._run_streams([x], [iter(prng.split(key, 256))],
                              [beaver.InlineTTP()], tcomm.CoalescingComm(),
                              TPARAMS, auto_batch=False)[0]


def _jmpc_x(i: int, batch: int):
    """Request ``i``'s input shared by the reference (key 200 + i) and the
    same shares carried to the port."""
    jX = jmpc.MPCTensor.from_plain(jax.random.PRNGKey(200 + i),
                                   jax.numpy.asarray(_x(i, batch)))
    return jX, tmpc.MPCTensor(tring.from_limbs(np.asarray(jX.data.lo),
                                               np.asarray(jX.data.hi), "cpu"))


def _mix(seed: int):
    """``test_engine.py``'s seeded random mix: (batch, tenant) per request
    and an arrival order."""
    rnd = np.random.default_rng(seed)
    mix = [(int(rnd.integers(1, 5)), str(rnd.choice(["a", "b", "c"])))
           for _ in range(int(rnd.integers(1, 6)))]
    return mix, rnd.permutation(len(mix)).tolist()


def _u64(t):
    return tring.to_uint64_np(t) if isinstance(t, torch.Tensor) else \
        jring.to_uint64_np(t)


@pytest.fixture(scope="module")
def ref():
    """The reference engine, run once per mix the cases below share: the
    canonical mix (plain numpy inputs, so each engine secret-shares them
    itself), each seeded random mix, and the canonical pair under
    ``merge_identical``."""
    jparams = {k: jax.numpy.asarray(v) for k, v in _W.items()}
    jplan = japi.trace_plan(_japply, jparams, (2, D_IN), name="tiny")
    jplan = jplan.with_hb(japi.HBConfig((japi.HBLayer(k=21, m=13),) * 2,
                                        jplan.group_elements))
    assert jplan.digest() == TPLAN.digest()

    def engine(policy=None):
        return jserve.InferenceEngine(_japply, jparams, JTinyCfg(), jplan,
                                      japi.Session(key=0), policy=policy)

    out = {}
    eng = engine()
    futs = [eng.submit(t, _x(i, b)) for i, (t, b) in
            enumerate(zip(["alice", "bob", "alice"], [2, 2, 3]))]
    out["canonical"] = [_u64(f.result().data) for f in futs]
    for seed in SEEDS:
        mix, order = _mix(seed)
        eng = engine()
        futs = {rid: eng.submit(mix[rid][1], _jmpc_x(rid, mix[rid][0])[0],
                                request_id=rid) for rid in order}
        out[seed] = {rid: _u64(f.result().data) for rid, f in futs.items()}
    eng = engine(jserve.BatchPolicy(merge_identical=True))
    futs = [eng.submit(t, _x(42, 2)) for t in ("a", "b")]
    out["merged"] = [_u64(f.result().data) for f in futs]
    return out


# ---------------------------------------------------------------------------
# Bit identity against the reference engine and the serial oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loop", ["python", "scan"])
def test_canonical_mix_bit_identical_and_max_over_requests(ref, loop, monkeypatch):
    """Mirrors ``test_engine.py::test_canonical_mix_bit_identical_and_max_over_requests``:
    two identical shapes and a ragged one, one micro-batch; measured rounds
    and bytes equal ``simulate_merged``, the rounds are the max over the
    requests, and every request's shares equal the reference engine's and
    the serial oracle's, on either round loop."""
    monkeypatch.setenv("HB_ROUND_LOOP", loop)
    engine = _engine()
    batches = [2, 2, 3]
    xs = [_x(i, b) for i, b in enumerate(batches)]
    futs = [engine.submit(t, x) for t, x in zip(["alice", "bob", "alice"], xs)]
    outs = [f.result() for f in futs]
    assert len(engine.reports) == 1
    rep = engine.reports[0]
    assert rep.n_requests == 3 and rep.wall_s > 0
    sched = schedule.simulate_merged(
        [engine.plan_for_shape((b, D_IN)).call_specs() for b in batches],
        auto_batch=False)
    assert rep.measured_rounds == sched.n_rounds == rep.predicted_rounds
    assert rep.measured_bytes == sched.bytes_tx == rep.predicted_bytes
    per_request = [engine.plan_for_shape((b, D_IN)).schedule().n_rounds
                   for b in batches]
    assert rep.measured_rounds == max(per_request)
    assert rep.serial_rounds == sum(per_request) > rep.measured_rounds
    assert rep.rounds_saved_ratio == pytest.approx(3.0)
    for i, (x, out) in enumerate(zip(xs, outs)):
        np.testing.assert_array_equal(_u64(out.data), ref["canonical"][i])
        assert torch.equal(out.data, _serial_oracle(x, i).data)


def test_reordered_submissions_do_not_change_outputs():
    """Mirrors ``test_engine.py::test_reordered_submissions_do_not_change_outputs``:
    a request's output depends on its id, never on admission order."""
    xs = {7: _x(0, 2), 11: _x(1, 3), 13: _x(2, 2)}

    def run(order):
        engine = _engine()
        futs = {rid: engine.submit("t", xs[rid], request_id=rid) for rid in order}
        return {rid: f.result().data for rid, f in futs.items()}

    a, b = run([7, 11, 13]), run([13, 7, 11])
    for rid in xs:
        assert torch.equal(a[rid], b[rid])


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_random_mix_bit_identical_and_rounds_predicted(ref, seed):
    """Mirrors ``test_engine.py::test_seeded_random_mix_bit_identical_and_rounds_predicted``:
    a random mix of batch sizes and tenants in a random arrival order; every
    request's shares equal the reference engine's and the serial oracle's,
    and every batch's rounds and bytes equal ``simulate_merged``."""
    mix, order = _mix(seed)
    engine = _engine()
    futs = {rid: engine.submit(mix[rid][1], _jmpc_x(rid, mix[rid][0])[1],
                               request_id=rid) for rid in order}
    outs = {rid: f.result() for rid, f in futs.items()}
    for rid, (batch, _) in enumerate(mix):
        np.testing.assert_array_equal(_u64(outs[rid].data), ref[seed][rid])
        want = _serial_oracle(_jmpc_x(rid, batch)[1], rid)
        assert torch.equal(outs[rid].data, want.data)
    for rep in engine.reports:
        sched = schedule.simulate_merged(
            [engine.plan_for_shape(s).call_specs() for s in rep.shapes],
            auto_batch=False)
        assert (rep.measured_rounds, rep.measured_bytes) == \
            (sched.n_rounds, sched.bytes_tx)


def test_merge_identical_one_payload_per_round(ref):
    """Mirrors ``test_engine.py::test_merge_identical_one_payload_per_round_reveals_sane``:
    identical shapes merge into one protocol stream, so every fused round
    carries one payload, rounds and bytes equal the auto-batched schedule,
    and the reveals stay within the approximation's error of the
    plaintext (the reveal level, as the reference holds it).  The merged
    split equals the reference engine's too."""
    x = _x(42, 2)
    merged = _engine(policy=BatchPolicy(merge_identical=True))
    futs = [merged.submit(t, x) for t in ("a", "b")]
    outs = [f.result() for f in futs]
    rep = merged.reports[0]
    sched = schedule.simulate_merged(
        [merged.plan_for_shape((2, D_IN)).call_specs()] * 2, auto_batch=True)
    assert (rep.measured_rounds, rep.measured_bytes) == \
        (rep.predicted_rounds, rep.predicted_bytes) == (sched.n_rounds, sched.bytes_tx)
    assert list(merged.comm.round_parts) == [1] * sched.n_rounds
    want = _tapply(TPARAMS, torch.from_numpy(x)).numpy()
    for out, jout in zip(outs, ref["merged"]):
        np.testing.assert_allclose(out.reveal_np(), want, atol=0.6)
        np.testing.assert_array_equal(_u64(out.data), jout)


def test_api_reexports_engine_types():
    """Mirrors ``test_engine.py::test_api_reexports_engine_types`` (PEP 562)."""
    assert tapi.InferenceEngine is serve.InferenceEngine
    assert tapi.BatchPolicy is serve.BatchPolicy
    assert tapi.BatchReport is serve.BatchReport
    assert tapi.Request is serve.Request
    assert tapi.RequestFuture is serve.RequestFuture
    with pytest.raises(AttributeError):
        tapi.NoSuchThing


def test_duplicate_request_id_rejected():
    """Mirrors ``test_engine.py::test_duplicate_request_id_rejected``."""
    engine = _engine()
    engine.submit("t", _x(0, 2), request_id=3)
    with pytest.raises(ValueError, match="already submitted"):
        engine.submit("t", _x(1, 2), request_id=3)


# ---------------------------------------------------------------------------
# Batching policy and the plan cache
# ---------------------------------------------------------------------------

def test_policy_max_batch_splits_queue():
    """Mirrors ``test_engine.py::test_policy_max_batch_splits_queue``."""
    engine = _engine(policy=BatchPolicy(max_batch=2))
    futs = [engine.submit("t", _x(i, 2)) for i in range(5)]
    engine.flush()
    assert [r.n_requests for r in engine.reports] == [2, 2, 1]
    assert all(f.done for f in futs)


def test_policy_min_gain_one_forces_serial_batches():
    """Mirrors ``test_engine.py::test_policy_min_gain_one_forces_serial_batches``."""
    engine = _engine(policy=BatchPolicy(min_gain=1.0))
    for i in range(3):
        engine.submit("t", _x(i, 2))
    engine.flush()
    assert [r.n_requests for r in engine.reports] == [1, 1, 1]


def test_poll_respects_deadline_flush_drains():
    """Mirrors ``test_engine.py::test_poll_respects_deadline_flush_drains``."""
    engine = _engine(policy=BatchPolicy(max_wait_s=10.0, max_batch=8))
    engine.submit("t", _x(0, 2), arrival_s=0.0)
    engine.submit("t", _x(1, 2), arrival_s=1.0)
    assert engine.poll(now_s=5.0) == []
    assert engine.pending == 2
    reports = engine.poll(now_s=10.5)
    assert len(reports) == 1 and reports[0].n_requests == 2
    assert engine.pending == 0
    assert reports[0].waits_s == (10.5, 9.5)


def test_pow2_bucketing_pads_and_slices():
    """Mirrors ``test_engine.py::test_pow2_bucketing_pads_and_slices``: the
    padded request's output equals the serial oracle of the padded input
    (zero shares), sliced back."""
    engine = _engine(policy=BatchPolicy(bucket="pow2"))
    x = _x(0, 3)
    out = engine.submit("t", x).result()
    assert out.shape == (3, D_OUT)
    assert engine.reports[0].shapes == ((4, D_IN),)
    session = tapi.Session(key=0, device="cpu")
    enc_key, key = prng.split(session.request_key(0))
    X = tmpc.MPCTensor.from_plain(enc_key, torch.from_numpy(x))
    padded = tmpc.MPCTensor(torch.cat([X.data, torch.zeros_like(X.data[:, :1])], 1))
    model = tapi.compile(_tapply, TPARAMS, TTinyCfg(), TPLAN, session)
    want = model._run_streams([padded], [iter(prng.split(key, 256))],
                              [beaver.InlineTTP()], tcomm.CoalescingComm(), TPARAMS,
                              auto_batch=False)[0]
    assert torch.equal(out.data, want.data[:, :3])
    engine.submit("t", _x(1, 4))
    engine.flush()
    assert engine.plan_cache_size == 2


def test_pow2_bucket_does_not_reuse_unbucketed_seed_plan():
    """Mirrors ``test_engine.py::test_pow2_bucket_does_not_reuse_unbucketed_seed_plan``."""
    plan3 = tapi.trace_plan(_tapply, TPARAMS, (3, D_IN), hb=TPLAN.hb, name="tiny3")
    engine = _engine(plan=plan3, policy=BatchPolicy(bucket="pow2"))
    assert tuple(engine.plan_for_shape((3, D_IN)).input_shape) == (4, D_IN)
    assert engine.submit("t", _x(0, 3)).result().shape == (3, D_OUT)
    assert engine.reports[0].predicted_rounds == engine.reports[0].measured_rounds


def test_fully_culled_plan_batches_without_crashing():
    """Mirrors ``test_engine.py::test_fully_culled_plan_batches_without_crashing``."""
    culled = TPLAN.with_hb(tapi.HBConfig((tapi.HBLayer(k=0, m=0),) * 2,
                                         TPLAN.group_elements))
    engine = _engine(plan=culled)
    futs = [engine.submit("t", _x(i, 2)) for i in range(3)]
    assert all(f.result() is not None for f in futs)
    rep = engine.reports[0]
    assert rep.n_requests == 3 and rep.measured_rounds == 0


def test_unservable_shape_fails_at_submit():
    """Mirrors ``test_engine.py::test_unservable_shape_fails_at_submit``."""
    engine = _engine(apply_fn=None)
    ok = engine.submit("t", _x(0, 2))
    with pytest.raises(ValueError, match="no traced plan"):
        engine.submit("t", _x(1, 3))
    assert engine.pending == 1
    assert ok.result() is not None


def test_plan_cache_reuses_traced_shapes():
    """Mirrors ``test_engine.py::test_plan_cache_reuses_traced_shapes``."""
    engine = _engine()
    for i, b in enumerate([2, 3, 2, 3, 2]):
        engine.submit("t", _x(i, b))
    engine.flush()
    assert engine.plan_cache_size == 2


# ---------------------------------------------------------------------------
# Tenancy, shedding, retry, timeouts and typed errors
# ---------------------------------------------------------------------------

def test_tenant_budget_fails_future_without_running():
    """Mirrors ``test_engine.py::test_tenant_budget_fails_future_without_running``."""
    per_request = 2 * D_HID + 2 * D_OUT
    engine = _engine(tenant_budgets={"capped": per_request + 1})
    ok = engine.submit("capped", _x(0, 2))
    over = engine.submit("capped", _x(1, 2))
    free = engine.submit("other", _x(2, 2))
    assert ok.result() is not None
    assert free.result() is not None
    with pytest.raises(beaver.TripleBudgetExceeded, match="capped"):
        over.result()
    usage = engine.tenant_usage("capped")
    assert usage["consumed_elements"] == per_request
    assert usage["remaining_elements"] == 1
    assert all(over.request.id not in r.request_ids for r in engine.reports)


def test_metered_provider_counts_and_caps():
    """Mirrors ``test_engine.py::test_metered_provider_counts_and_caps``."""
    p = beaver.MeteredProvider(beaver.InlineTTP(), budget_elements=100)
    assert p.relu_triples(0, 8) is None
    assert p.relu_triples(64, 0) is None
    p.relu_triples(60, 8)
    assert (p.consumed_elements, p.consumed_bundles) == (60, 1)
    with pytest.raises(beaver.TripleBudgetExceeded):
        p.relu_triples(41, 8)
    assert p.remaining_elements == 40


def test_deadline_shedding_typed_and_counted():
    """Mirrors ``test_engine.py::test_deadline_shedding_typed_and_counted``."""
    engine = _engine()
    doomed = engine.submit("alice", _x(0, 2), deadline_s=0.0)
    ok = engine.submit("bob", _x(1, 2))
    assert ok.result() is not None
    with pytest.raises(errors.DeadlineExceeded) as ei:
        doomed.result()
    assert (ei.value.request_id, ei.value.tenant) == (doomed.request.id, "alice")
    stats = engine.stats()
    assert stats["shed"] == 1 and stats["requests"] == 1
    assert engine.reports[-1].shed == 1
    assert engine.tenant_usage("alice")["consumed_elements"] == 0
    fine = engine.submit("alice", _x(2, 2), deadline_s=60.0)
    assert fine.result() is not None
    assert engine.stats()["shed"] == 1


class _FlakyComm(tcomm.SimComm):
    """SimComm that raises a retryable ``CommTimeout`` at its ``fail_at``-th
    exchange, once (a transient fault the engine's batch retry absorbs)."""

    def __init__(self, fail_at: int):
        self.fail_at, self.swaps, self.raised = fail_at, 0, 0

    def swap(self, x):
        self.swaps += 1
        if self.swaps == self.fail_at and not self.raised:
            self.raised += 1
            raise errors.CommTimeout(f"exchange {self.swaps} dropped")
        return super().swap(x)


def test_batch_retry_on_transient_fault_bit_identical():
    """Mirrors ``test_engine.py::test_batch_retry_on_transient_faults_bit_identical``
    with a local flaky comm in place of the fault injector (ROADMAP queue
    1, item 6): a retryable fault mid-batch re-executes the whole batch,
    the stateful ``StreamingTTP`` providers rolled back, so the outputs
    equal a fault-free engine's and each tenant is billed once."""
    def factory(tenant):
        return beaver.StreamingTTP(prng.PRNGKey(len(tenant), "cpu"))

    clean = _engine(provider_factory=factory)
    want = [clean.submit(t, _x(i, 2)).result()
            for i, t in enumerate(["alice", "bob"])]
    flaky = _FlakyComm(fail_at=5)
    engine = _engine(session=tapi.Session(key=0, comm=flaky, device="cpu"),
                     provider_factory=factory)
    futs = [engine.submit(t, _x(i, 2)) for i, t in enumerate(["alice", "bob"])]
    for f, w in zip(futs, want):
        assert torch.equal(f.result().data, w.data)
    assert flaky.raised == 1
    assert engine.stats()["retries"] == 1 == engine.reports[-1].retries
    rep = engine.reports[-1]
    assert (rep.measured_rounds, rep.measured_bytes) == \
        (rep.predicted_rounds, rep.predicted_bytes)
    per_request = 2 * D_HID + 2 * D_OUT
    for tenant in ("alice", "bob"):
        assert engine.tenant_usage(tenant)["consumed_elements"] == per_request


def _chaos_engine(fault_plan, *, resilient_retries=3, **kw):
    """An engine whose session comm realizes ``fault_plan`` below a
    ``ResilientComm`` (``test_engine.py``'s ``_chaos_engine``); returns
    (engine, injector, resilient)."""
    fic = faults.FaultInjectingComm(fault_plan)
    rc = tcomm.ResilientComm(fic, max_retries=resilient_retries)
    engine = _engine(session=tapi.Session(key=0, comm=rc, device="cpu"), **kw)
    return engine, fic, rc


def test_batch_retry_on_transient_faults_bit_identical():
    """Mirrors ``test_engine.py::test_batch_retry_on_transient_faults_bit_identical``:
    transport retry budget 0 forces every transient of a real
    ``FaultInjectingComm`` up to the engine; the whole batch re-executes
    (stateful ``StreamingTTP`` providers rolled back, same request keys)
    and the results equal a fault-free engine's, each tenant billed once."""
    def factory(tenant):
        return beaver.StreamingTTP(prng.PRNGKey(len(tenant), "cpu"))

    clean = _engine(provider_factory=factory)
    f_clean = [clean.submit(t, _x(i, 2)) for i, t in enumerate(["alice", "bob"])]
    want = [f.result() for f in f_clean]
    engine, fic, rc = _chaos_engine(faults.FaultPlan.seeded(3, 10, drops=1,
                                                            corrupts=1),
                                    resilient_retries=0, provider_factory=factory)
    futs = [engine.submit(t, _x(i, 2)) for i, t in enumerate(["alice", "bob"])]
    for f, w in zip(futs, want):
        assert torch.equal(f.result().data, w.data)
    stats = engine.stats()
    assert stats["retries"] == 2 == engine.reports[-1].retries
    assert fic.injected["drop"] == 1 and fic.injected["corrupt"] == 1
    per_request = 2 * D_HID + 2 * D_OUT
    assert engine.tenant_usage("alice")["consumed_elements"] == per_request


def test_transport_absorbs_faults_engine_counts_recovery():
    """Mirrors ``test_engine.py::test_transport_absorbs_faults_engine_counts_recovery``:
    with transport-level retries available the engine never re-runs the
    batch; it reports the rounds the transport healed."""
    engine, fic, rc = _chaos_engine(faults.FaultPlan.seeded(5, 10, drops=2,
                                                            corrupts=1),
                                    resilient_retries=3)
    out = engine.submit("alice", _x(0, 2)).result()
    assert torch.equal(out.data, _serial_oracle(_x(0, 2), 0).data)
    stats = engine.stats()
    assert stats["retries"] == 0
    assert stats["faults_recovered"] == 3 == engine.reports[-1].faults_recovered
    assert rc.retries == 3 and rc.recovered == 3
    rep = engine.reports[-1]
    assert (rep.measured_rounds, rep.measured_bytes) == \
        (rep.predicted_rounds, rep.predicted_bytes)


def test_party_crash_restart_hook_retries_batch():
    """Mirrors ``test_engine.py::test_party_crash_restart_hook_retries_batch``:
    a mid-replay crash fails the batch unless ``on_party_crash`` revives
    the transport; with the hook, the retried results are bit-identical."""
    engine, fic, rc = _chaos_engine(faults.FaultPlan.seeded(
        0, 10, drops=0, corrupts=0, crash_round=2))
    fut = engine.submit("alice", _x(0, 2))
    with pytest.raises(errors.PartyCrashed):
        engine.flush()
    with pytest.raises(errors.PartyCrashed) as ei:
        fut.result()
    assert ei.value.request_id == fut.request.id

    holder = {}
    engine2, fic2, rc2 = _chaos_engine(
        faults.FaultPlan.seeded(0, 10, drops=0, corrupts=0, crash_round=2),
        on_party_crash=lambda e: holder["fic"].restart())
    holder["fic"] = fic2
    out = engine2.submit("alice", _x(0, 2)).result()
    assert torch.equal(out.data, _serial_oracle(_x(0, 2), 0).data)
    assert fic2.restarts == 1 and engine2.stats()["retries"] == 1


def test_non_retryable_failure_fails_every_future():
    """A fault that is not retryable fails the batch's futures with it (the
    reference's ``PartyCrashed`` path without a restart hook)."""
    class Crashing(tcomm.SimComm):
        def swap(self, x):
            raise errors.PartyCrashed("peer gone")

    engine = _engine(session=tapi.Session(key=0, comm=Crashing(), device="cpu"))
    fut = engine.submit("alice", _x(0, 2))
    with pytest.raises(errors.PartyCrashed):
        engine.flush()
    with pytest.raises(errors.PartyCrashed) as ei:
        fut.result()
    assert ei.value.request_id == fut.request.id


def test_result_timeout_raises_instead_of_hanging():
    """Mirrors ``test_engine.py::test_result_timeout_raises_instead_of_hanging``."""
    engine = _engine(policy=BatchPolicy(max_batch=8, min_gain=-1.0))
    fut = engine.submit("alice", _x(0, 2))
    with pytest.raises(errors.ResultTimeout) as ei:
        fut.result(timeout_s=0.05)
    assert (ei.value.request_id, ei.value.tenant) == (fut.request.id, "alice")
    assert not fut.done
    engine.flush()
    assert fut.result() is not None


def test_typed_errors_preserve_builtin_contracts():
    """Mirrors ``test_engine.py::test_typed_errors_preserve_builtin_contracts``."""
    engine = _engine()
    engine.submit("alice", _x(0, 2))
    with pytest.raises(errors.DuplicateRequest):
        engine.submit("alice", _x(0, 2), request_id=0)
    assert issubclass(errors.DuplicateRequest, ValueError)
    assert issubclass(errors.ShapeMismatch, ValueError)
    assert issubclass(errors.UnregisteredModel, KeyError)
    assert issubclass(errors.TripleBudgetExceeded, RuntimeError)
    assert beaver.TripleBudgetExceeded is errors.TripleBudgetExceeded

    class Unknown:
        pass

    with pytest.raises(KeyError, match="no MPC forward"):
        tapi.compile(None, {}, Unknown(), TPLAN, tapi.Session(key=0, device="cpu"))


def test_stats_and_straggler_watchdog():
    """``stats()`` totals over the executed batches, and the watchdog fed
    one synchronized wall per fused round per batch."""
    engine = _engine(policy=BatchPolicy(max_batch=1))
    for i in range(3):
        engine.submit("t", _x(i, 2))
    engine.flush()
    stats = engine.stats()
    assert (stats["requests"], stats["batches"]) == (3, 3)
    assert stats["fused_rounds"] == stats["serial_rounds"] == \
        sum(r.measured_rounds for r in engine.reports)
    assert stats["rounds_saved_ratio"] == 1.0
    assert engine.watchdog._n == 3 and engine.watchdog.ewma > 0


# ---------------------------------------------------------------------------
# The background pump and the HTTP frontend (tests/test_frontend.py)
# ---------------------------------------------------------------------------

def test_pump_submit_alone_makes_progress():
    """Mirrors ``test_frontend.py::test_pump_submit_alone_makes_progress``:
    with the pump running, submission alone resolves the futures, bit
    identical to an engine driven by hand."""
    manual = _engine()
    want = [manual.submit("alice", _x(10 + i, 2)) for i in range(3)]
    manual.flush()
    engine = _engine()
    engine.start_pump(interval_s=0.002, max_wait_s=0.02)
    try:
        futs = [engine.submit("alice", _x(10 + i, 2)) for i in range(3)]
        outs = [f.result(timeout_s=WAIT_S) for f in futs]
        assert all(f.done for f in futs)
        assert engine.pending == 0 and engine.last_pump_error is None
        assert engine.stats()["requests"] == 3
        for out, w in zip(outs, want):
            assert torch.equal(out.data, w.result().data)
    finally:
        engine.stop_pump(timeout_s=WAIT_S)
    assert not engine.pump_running


def test_pump_result_times_out_typed():
    """Mirrors ``test_frontend.py::test_pump_result_times_out_typed``."""
    engine = _engine()
    engine.start_pump(interval_s=10.0, max_wait_s=10.0)
    try:
        fut = engine.submit("alice", _x(20, 2))
        with pytest.raises(errors.ResultTimeout):
            fut.result(timeout_s=0.05)
    finally:
        engine.stop_pump(timeout_s=WAIT_S)
        engine.flush()


def test_poll_and_flush_stay_manual_overrides():
    """Mirrors ``test_frontend.py::test_poll_and_flush_stay_manual_overrides``."""
    engine = _engine()
    assert not engine.pump_running
    f1 = engine.submit("alice", _x(30, 2))
    assert engine.pending == 1
    engine.flush()
    assert f1.done and engine.pending == 0
    engine.start_pump(interval_s=0.002, max_wait_s=5.0)
    try:
        f2 = engine.submit("bob", _x(31, 2))
        engine.flush()
        assert f2.done
    finally:
        engine.stop_pump(timeout_s=WAIT_S)


def test_pump_concurrent_submitters_stress():
    """More submitting threads than cores, a shortened switch interval, the
    pump running: every auto-assigned id is distinct (a lost update of the
    id counter would repeat one), every future resolves, the totals count
    every request once, and every output equals its serial oracle."""
    import os
    import sys

    n = (os.cpu_count() or 4) + 4
    engine = _engine(policy=BatchPolicy(max_batch=4))
    engine.start_pump(interval_s=0.001, max_wait_s=0.005)
    futs, errs = [None] * n, []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(i):
            try:
                futs[i] = engine.submit(f"t{i % 3}", _x(i, 1 + i % 2))
            except Exception as e:          # noqa: BLE001 (asserted below)
                errs.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
            assert not t.is_alive()
        outs = {f.request.id: f.result(timeout_s=WAIT_S) for f in futs}
    finally:
        sys.setswitchinterval(old)
        engine.stop_pump(timeout_s=WAIT_S)
    assert not errs and engine.last_pump_error is None
    assert sorted(outs) == list(range(n))
    assert engine.stats()["requests"] == n == sum(r.n_requests for r in engine.reports)
    for i, f in enumerate(futs):
        x = _x(i, 1 + i % 2)
        assert torch.equal(outs[f.request.id].data,
                           _serial_oracle(x, f.request.id).data)


def _http(method, url, body=None, timeout=WAIT_S):
    req = urllib.request.Request(
        url, method=method,
        data=json.dumps(body).encode() if body is not None else None)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def test_frontend_http_roundtrip():
    """Mirrors ``test_frontend.py::test_frontend_http_roundtrip``, with
    concurrent clients: three ``POST /infer`` from threads, each reply's
    ``y`` equal to the reveal of the same request id on a direct engine;
    ``/healthz``, ``/stats`` (no ``transport`` key: the engine runs over
    ``SimComm``, no socket), a 404 and a 400."""
    engine = _engine(policy=BatchPolicy(max_batch=2))
    frontend = serve.Frontend(engine)
    host, port = frontend.serve_background(HOST, 0)
    base = f"http://{host}:{port}"
    try:
        status, health = _http("GET", f"{base}/healthz")
        assert status == 200 and health["ok"] and health["pump"]
        replies = {}

        def post(i):
            replies[i] = _http("POST", f"{base}/infer",
                               {"tenant": "alice", "x": _x(40 + i, 2).tolist(),
                                "request_id": 100 + i, "timeout_s": WAIT_S})

        threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
            assert not t.is_alive()
        direct = _engine()
        for i in range(3):
            status, resp = replies[i]
            assert status == 200, resp
            assert resp["id"] == 100 + i and resp["tenant"] == "alice"
            assert resp["batch"]["measured_rounds"] == resp["batch"]["predicted_rounds"] > 0
            want = direct.submit("alice", _x(40 + i, 2), request_id=100 + i)
            np.testing.assert_array_equal(
                np.asarray(resp["y"], np.float32),
                want.result().reveal().numpy())
        status, stats = _http("GET", f"{base}/stats")
        assert status == 200
        assert stats["requests"] == 3 and stats["frontend_requests"] == 3
        assert "transport" not in stats
        status, health = _http("GET", f"{base}/healthz")
        assert health["last_pump_error"] is None
        assert _http("GET", f"{base}/nope")[0] == 404
        status, resp = _http("POST", f"{base}/infer", {"tenant": "a"})
        assert status == 400 and "x" in resp["error"]
    finally:
        frontend.close()
    assert not engine.pump_running


# ---------------------------------------------------------------------------
# The private LM through the engine (per-site Beaver opens merged)
# ---------------------------------------------------------------------------

def test_lm_engine_merges_opens_and_equals_serial_oracle():
    """The smoke LM (``qwen1.5-0.5b-smoke``, one layer, 4 tokens) served by an
    engine built with ``apply_fn=None`` on ``lm.trace``'s plan: two requests
    run as one batch on the generator loop; its rounds and bytes equal the
    engine's merged schedule (the ReLU rows by ``simulate_merged``, each
    product site's two opens in one round by ``simulate_open``: reference
    ``engine.py:465-480``) and ``plan.schedule(streams=2)`` without
    auto-batching; each request's shares equal its serial oracle, its
    reveal the plaintext twin within 5e-2; another shape fails at submit."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import lm

    cfg = dataclasses.replace(configs.get("qwen1.5-0.5b-smoke"), n_layers=1)
    params = lm.init(cfg, torch.Generator().manual_seed(0))
    plan = lm.trace(params, cfg, 1, 4)
    assert plan.opens
    engine = InferenceEngine(None, params, cfg, plan, tapi.Session(key=0, device="cpu"))
    hs = [np.random.default_rng(60 + i).standard_normal((1, 4, cfg.d_model))
          .astype(np.float32) * 0.5 for i in range(2)]
    futs = [engine.submit(t, h) for t, h in zip(("alice", "bob"), hs)]
    outs = [f.result() for f in futs]
    rep = engine.reports[0]
    sched = plan.schedule(streams=2, auto_batch=False)
    assert rep.n_requests == 2
    assert (rep.measured_rounds, rep.measured_bytes) == \
        (rep.predicted_rounds, rep.predicted_bytes) == (sched.n_rounds, sched.bytes_tx)
    assert rep.measured_rounds == plan.schedule().n_rounds
    model = tapi.compile(None, params, cfg, plan, tapi.Session(key=0, device="cpu"))
    for rid, (h, out) in enumerate(zip(hs, outs)):
        key = model.session.request_key(rid)
        enc_key, key = prng.split(key)
        X = tmpc.MPCTensor.from_plain(enc_key, torch.from_numpy(h))
        want = model._run_streams([X], [iter(prng.split(key, 256))],
                                  [beaver.InlineTTP()], tcomm.CoalescingComm(),
                                  params, auto_batch=False)[0]
        assert torch.equal(out.data, want.data)
        np.testing.assert_allclose(out.reveal_np(),
                                   lm.mpc_reference(params, torch.from_numpy(h), cfg)
                                   .numpy(), atol=5e-2)
    with pytest.raises(errors.ShapeMismatch):
        engine.submit("alice", np.zeros((1, 5, cfg.d_model), np.float32))


# ---------------------------------------------------------------------------
# Two-party serving: the engine link and the leader's deployment CLI
# ---------------------------------------------------------------------------

def _smoke_resnet():
    """RESNET_SMOKE (the port's seeded weights) and its reduced plan at
    batch 2, as ``test_frontend.py``'s ``smoke`` fixture."""
    from repro_torch.configs import RESNET_SMOKE
    from repro_torch.models import resnet

    params = resnet.init(RESNET_SMOKE, seed=0, device="cpu")

    def afn(p, v, relu_fn=None):
        return resnet.apply(p, v, RESNET_SMOKE, relu_fn=relu_fn)

    plan = tapi.trace_plan(afn, params, (2, 3, 8, 8), name="smoke")
    hb = tapi.HBConfig(tuple([tapi.HBLayer(k=21, m=13)] * (plan.n_groups - 1)
                             + [tapi.HBLayer(k=13, m=13)]), plan.group_elements)
    return afn, params, plan.with_hb(hb), RESNET_SMOKE


def _smoke_x(seed, batch=2):
    return np.random.default_rng(seed).standard_normal(
        (batch, 3, 8, 8)).astype(np.float32) * 0.5


def _sim_engine_outs(afn, params, plan, cfg, reqs, ttp_seed=0):
    """The single-process SimComm engine's outputs for ``reqs``."""
    from repro_torch.transport import tenant_provider_factory

    ref = InferenceEngine(afn, params, cfg, plan,
                          tapi.Session(key=0, device="cpu"),
                          provider_factory=tenant_provider_factory(
                              ttp_seed, device="cpu"))
    futs = [ref.submit(t, x) for t, x in reqs]
    ref.flush()
    return [f.result(timeout_s=WAIT_S) for f in futs]


def test_engine_link_bit_identical_to_sim_engine():
    """Mirrors ``test_frontend.py::test_engine_link_bit_identical_to_sim_engine``:
    mixed-tenant submissions through the leader/follower split (a leader
    engine over ``Session.connect`` with ``EngineLink``, a
    ``serve_follower`` thread with only its own rows) resolve to outputs
    bit-identical (share level) to the single-process SimComm engine on the
    same request ids, inputs and seeds; the follower serves one batch and
    both sides' framed wire bytes equal the batch's merged schedule."""
    from repro_torch.transport import (EngineLink, free_port, serve_follower,
                                       tenant_provider_factory)

    afn, params, plan, cfg = _smoke_resnet()
    reqs = [("alice", _smoke_x(50)), ("bob", _smoke_x(51)), ("alice", _smoke_x(52))]
    ref_outs = _sim_engine_outs(afn, params, plan, cfg, reqs)

    port = free_port()
    follower_done = {}

    def follower():
        session = tapi.Session.connect(
            1, peer=(HOST, port), key=0, session_id="link",
            plan_digest=plan.digest(), handshake_timeout_s=WAIT_S,
            timeout_s=WAIT_S, device="cpu")
        model = tapi.compile(afn, params, cfg, plan, session)
        try:
            follower_done["served"] = serve_follower(
                session.transport, model,
                provider_factory=tenant_provider_factory(0, party=1, device="cpu"))
            follower_done["bytes"] = session.transport.round_bytes
        finally:
            session.transport.close()

    t = threading.Thread(target=follower)
    t.start()
    session = tapi.Session.connect(
        0, listen=(HOST, port), key=0, session_id="link",
        plan_digest=plan.digest(), handshake_timeout_s=WAIT_S,
        timeout_s=WAIT_S, device="cpu")
    engine = InferenceEngine(afn, params, cfg, plan, session,
                             provider_factory=tenant_provider_factory(
                                 0, party=0, device="cpu"))
    link = EngineLink(engine)
    try:
        futs = [engine.submit(t_, x) for t_, x in reqs]
        engine.flush()
        for f, want in zip(futs, ref_outs):
            assert torch.equal(f.result(timeout_s=WAIT_S).data, want.data)
        rep = engine.reports[-1]
        assert rep.n_requests == 3
        assert (rep.measured_rounds, rep.measured_bytes) == \
            (rep.predicted_rounds, rep.predicted_bytes)
        framed = engine._merged_schedule(
            [type("R", (), {"shape": tuple(x.shape)})() for _, x in reqs]).framed()
        assert session.transport.round_bytes == list(framed.round_bytes)
    finally:
        link.shutdown()
        t.join(WAIT_S)
        session.transport.close()
    assert not t.is_alive()
    assert follower_done.get("served") == 1
    assert follower_done["bytes"] == session.transport.round_bytes


def test_frontend_cli_builds_the_leader_engine(tmp_path):
    """The leader's deployment CLI (``serve/frontend.py`` ``build_parser``,
    ``build_engine``) against a ``party_host --follow`` follower in a
    thread, from a serving-mode job directory (both parties derive the
    weights from its ``params_seed``): ``/stats`` carries the socket
    transport's counters, every request equals the single-process SimComm
    engine's, and the shutdown releases the follower."""
    from repro_torch.launch import party_host
    from repro_torch.serve import frontend as fe
    from repro_torch.transport import free_port, load_job, write_job

    afn, params, plan, cfg = _smoke_resnet()
    write_job(tmp_path, plan=plan, config="smoke", params_seed=0, infer_key=4,
              session_seed=0, ttp_seed=9)
    port = free_port()
    args = fe.build_parser().parse_args(
        ["--job", str(tmp_path), "--listen", f"{HOST}:{port}", "--max-batch", "4",
         "--device", "cpu"])
    assert (args.party, args.max_batch, args.http, args.device) == \
        (0, 4, "127.0.0.1:9001", "cpu")
    rc = {}
    follower = threading.Thread(target=lambda: rc.setdefault("rc", party_host.run(
        ["--party", "1", "--job", str(tmp_path), "--peer", f"{HOST}:{port}",
         "--follow", "--device", "cpu", "--timeout-s", str(WAIT_S)])))
    follower.start()
    engine, link = fe.build_engine(args, load_job(tmp_path))
    reqs = [("alice", _smoke_x(60)), ("bob", _smoke_x(61))]
    try:
        futs = [engine.submit(t_, x) for t_, x in reqs]
        engine.flush()
        outs = [f.result(timeout_s=WAIT_S) for f in futs]
        stats = fe.Frontend(engine)._stats()
        assert stats["transport"]["party"] == 0
        assert stats["transport"]["rounds"] == engine.reports[-1].measured_rounds
        assert stats["transport"]["retries"] == 0
    finally:
        link.shutdown()
        follower.join(WAIT_S)
        link.sock.close()
    assert not follower.is_alive() and rc["rc"] == 0
    want = _sim_engine_outs(afn, params, plan, cfg, reqs, ttp_seed=9)
    for got, w in zip(outs, want):
        assert torch.equal(got.data, w.data)
