"""The port's fault injection, resilient transport and round journal.

Mirrors the reference's ``tests/test_faults.py`` (its 9 cases without
hypothesis): under any seeded ``FaultPlan`` of transient faults the
resilient stack's outputs equal the frozen seed oracle
(``core/gmw_ref.py``, itself held bit-exact against the reference's);
retries match the plan exactly; ``CoalescingComm`` rounds and bytes equal
the schedule and ``ResilientComm``'s the framed schedule; a crash is not
retryable by re-send, and the journal resume completes bit-identically.
Against the reference directly: ``frame_checksum`` on seeded buffers and
sequence numbers (past 2^32 too), ``FaultPlan.seeded`` event for event,
the corrupted word's position, and one RESNET_SMOKE inference under a
seeded fault plan (the reference's shares and every ``ResilientComm`` and
injector counter), then crashed and resumed from a persisted journal."""
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import beaver as jbeaver, comm as jcomm, faults as jfaults
from repro_torch import api, errors
from repro_torch.configs import RESNET_SMOKE
from repro_torch.core import (beaver, comm as comm_lib, faults, fixed, gmw,
                              gmw_ref, prng, schedule, shares)

from test_torch_transport import _jsim_run, _smoke, _tmpc

_KM_POOL = [(64, 0), (21, 13), (20, 14), (5, 3), (2, 1)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _make_group(n, k, m, cone, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-3.5, 3.5, n).astype(np.float32))
    X = shares.share(prng.PRNGKey(seed, "cpu"), fixed.encode(x))
    tri = beaver.gen_relu_triples(prng.PRNGKey(seed + 1, "cpu"), n, k - m,
                                  cone=cone)
    return X, tri


def _mix(specs, cone, seed):
    keys, Xs, trs = [], [], []
    for i, (n, k, m) in enumerate(specs):
        X, tri = _make_group(n, k, m, cone, seed + 10 * i)
        keys.append(prng.PRNGKey(seed + 1000 + i, "cpu"))
        Xs.append(X)
        trs.append(tri)
    return keys, Xs, trs


def _check_chaos_mix(specs, fault_seed, cone=False, seed=0,
                     drops=1, corrupts=1, stalls=1):
    """A stream mix through the full chaos stack: bit-exact against the
    seed oracle, retry accounting, and round/byte counters against the
    schedule (re-sends excluded)."""
    kms = [(k, m) for _, k, m in specs]
    sched = schedule.simulate([(n, k - m) for n, k, m in specs],
                              cone=cone, auto_batch=False)
    plan = faults.FaultPlan.seeded(fault_seed, sched.n_rounds, drops=drops,
                                   corrupts=corrupts, stalls=stalls)
    fic = faults.FaultInjectingComm(plan)
    rc = comm_lib.ResilientComm(fic, max_retries=4)
    cc = comm_lib.CoalescingComm(rc)

    keys, Xs, trs = _mix(specs, cone, seed)
    outs = gmw.relu_many(keys, Xs, trs, cc, kms, cone=cone, auto_batch=False)

    ref_cm = comm_lib.SimComm()
    for (n, k, m), key, X, tri, out in zip(specs, keys, Xs, trs, outs):
        ref = gmw_ref.relu(key, X, tri, ref_cm, k=k, m=m, cone=cone)
        assert torch.equal(out, ref)

    assert rc.retries == plan.n_transient
    assert rc.recovered == plan.n_transient          # distinct rounds
    assert fic.injected["drop"] == plan.count("drop")
    assert fic.injected["stall"] == plan.count("stall")
    assert fic.injected["corrupt"] == plan.count("corrupt")
    assert (rc.faults_detected["timeout"]
            == plan.count("drop") + plan.count("stall"))
    assert rc.faults_detected["corrupt"] == plan.count("corrupt")

    assert cc.n_rounds == sched.n_rounds == fic.round
    assert cc.round_bytes == list(sched.round_bytes)
    framed = sched.framed()
    assert rc.round_bytes == list(framed.round_bytes)
    assert rc.bytes_tx == framed.bytes_tx
    assert rc.resent_bytes > 0 if plan.events else rc.resent_bytes == 0


# ---------------------------------------------------------------------------
# Against the reference directly
# ---------------------------------------------------------------------------

def test_frame_checksum_equals_reference():
    """Seeded (P, n) buffers under seqs 0 .. past 2^32: the port's
    device-side checksum is the reference's numpy one, bit for bit."""
    rng = np.random.default_rng(5)
    for P, n in ((2, 1), (2, 7), (1, 1000), (2, 4099), (1, 0)):
        w = rng.integers(0, 2 ** 32, (P, n), dtype=np.uint64).astype(np.uint32)
        for seq in (0, 1, 91, 2 ** 31 + 3, 2 ** 32 - 1, 2 ** 32 + 5, 2 ** 45 + 17):
            want = jcomm.frame_checksum(w, seq)
            got = comm_lib.frame_checksum(torch.from_numpy(w.view(np.int32)), seq)
            assert got.dtype == torch.int32 and got.shape == (P,)
            np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_fault_plan_seeded_equals_reference():
    for seed, n_rounds, kw in ((0, 10, {}), (7, 91, dict(drops=2, corrupts=3,
                                                         stalls=1, stall_s=0.01)),
                               (11, 3, dict(drops=4, corrupts=1)),
                               (3, 10, dict(crash_round=2)), (5, 0, {})):
        mine = faults.FaultPlan.seeded(seed, n_rounds, **kw)
        theirs = jfaults.FaultPlan.seeded(seed, n_rounds, **kw)
        assert [vars(e) for e in mine.events] == [vars(e) for e in theirs.events]
        assert mine.n_transient == theirs.n_transient


def test_corrupt_flips_the_reference_position():
    """The injected bit flip lands on the reference's word and bit, for
    word payloads and for ring payloads (their low words)."""
    ev = faults.FaultEvent(round=0, kind="corrupt", word=12345, bit=31)
    jev = jfaults.FaultEvent(round=0, kind="corrupt", word=12345, bit=31)
    words = np.arange(2 * 37, dtype=np.uint32).reshape(2, 37) * np.uint32(40503)
    got = faults._flip_bit(torch.from_numpy(words.view(np.int32)), ev)
    want = jfaults._flip_bit(words, jev)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    vals = torch.arange(2 * 37, dtype=torch.int64).reshape(2, 37) << 35
    flipped = faults._flip_bit(vals, ev)
    diff = (flipped ^ vals).numpy().view(np.uint64).reshape(-1)
    assert np.count_nonzero(diff) == 1
    assert diff[12345 % 74] == np.uint64(1) << np.uint64(31)


def test_resnet_smoke_fault_run_and_journal_resume_equal_reference(tmp_path):
    """RESNET_SMOKE under ``Session.resilient(fault_plan=...)`` (2 drops, 2
    corruptions, a stall) gives the reference's shares and the reference's
    ``ResilientComm`` and injector counters; the same inference crashed at
    round 9, its journal persisted and resumed on a fresh stack, gives them
    too."""
    s = _smoke()
    n_rounds = s["plan"].schedule().n_rounds
    kw = dict(drops=2, corrupts=2, stalls=1)
    jsession = japi.Session(key=0, provider=jbeaver.TriplePool(s["jpool"]))
    jsession.resilient(fault_plan=jfaults.FaultPlan.seeded(4, n_rounds, **kw))
    jout, jsess = _jsim_run(s, session=jsession)
    want = _tmpc(jout).data

    def run(session):
        model = api.compile(s["afn"], s["params"], RESNET_SMOKE, s["plan"], session)
        return model(s["X"], key=prng.PRNGKey(4, "cpu")).data

    session = api.Session(key=0, device="cpu",
                          provider=beaver.TriplePool(s["pool"]))
    session.resilient(fault_plan=faults.FaultPlan.seeded(4, n_rounds, **kw))
    assert torch.equal(run(session), want)
    mine, theirs = session.comm, jsess.comm
    assert isinstance(mine, comm_lib.ResilientComm)
    for attr in ("n_rounds", "round_bytes", "retries", "recovered",
                 "resent_bytes", "faults_detected"):
        assert getattr(mine, attr) == getattr(theirs, attr), attr
    assert mine.base.injected == theirs.base.injected
    assert mine.recovered == 5
    assert mine.round_bytes == list(s["plan"].schedule().framed().round_bytes)

    crashed = api.Session(key=0, device="cpu", provider=beaver.TriplePool(s["pool"]))
    crashed.resilient(fault_plan=faults.FaultPlan.seeded(4, n_rounds, drops=0,
                                                         corrupts=0, crash_round=9),
                      journal=faults.RoundJournal())
    with pytest.raises(errors.PartyCrashed):
        run(crashed)
    crashed.comm.snapshot(str(tmp_path))
    journal = faults.RoundJournal.load(str(tmp_path))
    assert len(journal) == 9
    resumed = api.Session(key=0, device="cpu", provider=beaver.TriplePool(s["pool"]))
    resumed.resilient(journal=journal)
    assert torch.equal(run(resumed), want)
    assert resumed.comm.replayed == 9
    assert resumed.comm.base.n_rounds == n_rounds - 9


# ---------------------------------------------------------------------------
# Deterministic scenario coverage (the reference's cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("specs,cone", [
    ([(64, 21, 13)], False),
    ([(96, 64, 0), (160, 21, 13), (64, 20, 14)], False),
    ([(48, 21, 13), (48, 20, 14)], True),
    ([(40, 2, 1), (40, 64, 0)], False),      # w=1 next to a deep ring
])
def test_chaos_mix_bit_exact(specs, cone):
    _check_chaos_mix(specs, fault_seed=11, cone=cone)


def test_no_faults_no_overhead():
    """An empty plan injects nothing: zero retries, zero resent bytes."""
    _check_chaos_mix([(64, 21, 13)], fault_seed=0,
                     drops=0, corrupts=0, stalls=0)


@pytest.mark.parametrize("case_seed", [0, 1, 2, 3])
def test_chaos_random_sweep(case_seed):
    """Random mixes under random fault schedules, including multi-event
    plans heavier than the default."""
    rng = np.random.default_rng(300 + case_seed)
    n_groups = int(rng.integers(1, 4))
    specs = []
    for _ in range(n_groups):
        n = int(rng.choice([16, 32, 50, 80]))
        k, m = _KM_POOL[int(rng.integers(len(_KM_POOL)))]
        specs.append((n, k, m))
    _check_chaos_mix(specs, fault_seed=int(rng.integers(2**16)),
                     cone=bool(case_seed % 2), seed=400 + case_seed,
                     drops=int(rng.integers(0, 3)),
                     corrupts=int(rng.integers(0, 3)),
                     stalls=int(rng.integers(0, 2)))


def test_retry_budget_exhaustion_raises_typed():
    """More consecutive faults on one round than the retry budget: the
    typed error propagates (transient events at the same round each
    consume one attempt)."""
    plan = faults.FaultPlan(tuple(
        faults.FaultEvent(round=0, kind="drop") for _ in range(3)))
    rc = comm_lib.ResilientComm(faults.FaultInjectingComm(plan), max_retries=1)
    with pytest.raises(errors.CommTimeout) as ei:
        rc.swap(torch.zeros((2, 4), dtype=torch.int32))
    assert errors.is_retryable(ei.value)
    assert rc.retries == 1                     # budget, not event count


def test_corruption_detected_wherever_it_lands():
    """Any single-bit flip in the framed buffer (payload, seq word or
    checksum word) fails verification and is healed by the re-send."""
    for word in [0, 3, 100, 101, 7919]:
        plan = faults.FaultPlan((faults.FaultEvent(
            round=0, kind="corrupt", word=word, bit=word % 32),))
        rc = comm_lib.ResilientComm(faults.FaultInjectingComm(plan))
        x = torch.arange(2 * 4, dtype=torch.int32).reshape(2, 4)
        out = rc.swap(x)
        assert torch.equal(out, comm_lib.SimComm().swap(x))
        assert rc.retries == 1 and rc.faults_detected["corrupt"] == 1


def test_crash_is_not_retryable_by_resend():
    plan = faults.FaultPlan.seeded(0, 4, drops=0, corrupts=0, crash_round=0)
    rc = comm_lib.ResilientComm(faults.FaultInjectingComm(plan), max_retries=5)
    with pytest.raises(errors.PartyCrashed) as ei:
        rc.swap(torch.zeros((2, 2), dtype=torch.int32))
    assert not errors.is_retryable(ei.value)
    assert rc.retries == 0                     # no re-send was attempted


def test_timeout_detection_on_slow_base():
    """ResilientComm's own elapsed-time check: a base comm slower than
    timeout_s raises CommTimeout after the budget, without any injector
    in the stack."""
    class SlowComm(comm_lib.SimComm):
        def swap(self, x):
            import time
            time.sleep(0.02)
            return super().swap(x)

    rc = comm_lib.ResilientComm(SlowComm(), max_retries=1, timeout_s=0.001)
    with pytest.raises(errors.CommTimeout):
        rc.swap(torch.zeros((2, 2), dtype=torch.int32))
    assert rc.faults_detected["timeout"] == 2        # attempt + retry


def test_crash_then_journal_resume_bit_identical(tmp_path):
    """Crash mid-replay, snapshot the journal at the barrier, restart a
    fresh stack with the journal mounted: recorded rounds replay off the
    wire and the final shares equal an uninterrupted run's exactly."""
    specs = [(64, 21, 13), (32, 20, 14)]
    kms = [(k, m) for _, k, m in specs]
    keys, Xs, trs = _mix(specs, False, 5)
    ref = gmw.relu_many(keys, Xs, trs,
                        comm_lib.CoalescingComm(comm_lib.SimComm()), kms,
                        auto_batch=False)

    plan = faults.FaultPlan.seeded(0, 10, drops=0, corrupts=0, crash_round=3)
    jc = faults.JournaledComm(comm_lib.ResilientComm(
        faults.FaultInjectingComm(plan)))
    with pytest.raises(errors.PartyCrashed):
        gmw.relu_many(keys, Xs, trs, comm_lib.CoalescingComm(jc), kms,
                      auto_batch=False)
    jc.snapshot(str(tmp_path))

    journal = faults.RoundJournal.load(str(tmp_path))
    assert len(journal) == 3                   # rounds completed pre-crash
    jc2 = faults.JournaledComm(comm_lib.ResilientComm(), journal=journal)
    outs = gmw.relu_many(keys, Xs, trs, comm_lib.CoalescingComm(jc2), kms,
                         auto_batch=False)
    assert jc2.replayed == 3
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)


def test_journal_snapshot_is_torn_write_safe(tmp_path):
    """An uncommitted snapshot directory is invisible to load()."""
    j = faults.RoundJournal()
    j.record([torch.arange(8, dtype=torch.int32).reshape(2, 4)])
    j.save(str(tmp_path))
    bad = tmp_path / "step_00000009"
    bad.mkdir()
    (bad / "arrays.npz").write_bytes(b"garbage")   # torn write, no sentinel
    loaded = faults.RoundJournal.load(str(tmp_path))
    assert len(loaded) == 1
    np.testing.assert_array_equal(loaded.rounds[0][0], j.rounds[0][0])
    assert loaded.rounds[0][0].dtype == np.uint32
