"""The port's two-party deployment over TCP, against the reference.

Mirrors the reference's ``tests/test_transport.py`` (14 cases): the socket
unit behaviour (address parsing, link shaping, the swap round trip and its
byte accounting, payload checks, the handshake's identity checks and
resume negotiation, idempotent re-send, a real socket timeout healed by
``ResilientComm``, an injected drop under the session stack), the
two-thread ``Session.connect`` RESNET_SMOKE inference (bit-identical to
the reference's ``SimComm`` run, bytes equal to ``Schedule.framed()``, the
wall under an injected RTT within the schedule's band) and the two OS
processes of ``python -m repro_torch.launch.party_host --device cpu`` from
a job directory (a clean run, and a kill after round 5 resumed from the
journals).  Three cross-package checks follow: a reference ``SocketComm``
and a port ``SocketComm`` handshake and exchange a DATA round; one JAX
party and one torch party run the smoke ResNet over ``Session.connect``;
a job directory written by either package loads in the other to the same
shares and pool leaves.

The smoke inputs (weights, input shares, triple pool) are made once by the
port and carried to the reference, so the reference runs only the
inference, on its generator loop (the reference semantics).  Every wait
on a thread or a subprocess has its own timeout; subprocesses pin torch to
one thread."""
import json
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import RESNET_SMOKE as RESNET_SMOKE_J
from repro.core import beaver as jbeaver, ring as jring
from repro.core.mpc_tensor import MPCTensor as JMPCTensor
from repro.models import resnet as jresnet
from repro.transport import SocketComm as JSocketComm, job as jjob
from repro_torch import api, errors
from repro_torch.configs import RESNET_SMOKE
from repro_torch.core import beaver, comm as comm_lib, faults as faults_lib, \
    prng, ring
from repro_torch.core.mpc_tensor import MPCTensor
from repro_torch.models import resnet
from repro_torch.transport import (LinkShaper, SocketComm, free_port, job,
                                   parse_address, write_job)

HOST = "127.0.0.1"
WAIT_S = 120.0           # every wait on a thread or a subprocess
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# helpers: a connected socket pair driven by two threads
# ---------------------------------------------------------------------------

def _pair(cls=SocketComm, cls1=None, **kw):
    """A handshaken (party0, party1) pair on localhost."""
    port = free_port()
    out = {}

    def _host():
        out[0] = cls.host((HOST, port), party=0, **kw)

    t = threading.Thread(target=_host)
    t.start()
    out[1] = (cls1 or cls).dial((HOST, port), party=1, **kw)
    t.join(WAIT_S)
    return out[0], out[1]


def _run_parties(fn0, fn1, timeout_s=WAIT_S):
    """Run one callable per party on its own thread; re-raise failures."""
    results, errs = {}, {}

    def _wrap(party, fn):
        try:
            results[party] = fn()
        except BaseException as e:       # noqa: BLE001 (surfaced below)
            errs[party] = e

    threads = [threading.Thread(target=_wrap, args=(p, f))
               for p, f in ((0, fn0), (1, fn1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    if errs:
        raise next(iter(errs.values()))
    assert not any(t.is_alive() for t in threads), "party thread hung"
    return results[0], results[1]


# ---------------------------------------------------------------------------
# the smoke setup, made by the port and carried to the reference
# ---------------------------------------------------------------------------

def _jbundle(b):
    """A port ReluTriples bundle as the reference's pytree."""
    if b is None:
        return None

    def jbin(t):
        return jbeaver.BinTriple(*(jnp.asarray(getattr(t, f).numpy().view(np.uint32))
                                   for f in ("a", "b", "c")))

    def jar(t):
        return jbeaver.ArithTriple(*(jring.Ring64(*map(jnp.asarray, ring.to_limbs(
            getattr(t, f)))) for f in ("a", "b", "c")))

    levels = (tuple(jbin(t) for t in b.bin_levels)
              if isinstance(b.bin_levels, tuple) else jbin(b.bin_levels))
    return jbeaver.ReluTriples(jbin(b.bin_init), levels, jar(b.b2a), jar(b.mult))


def _jmpc(data: torch.Tensor, frac_bits: int) -> JMPCTensor:
    return JMPCTensor(jring.Ring64(*map(jnp.asarray, ring.to_limbs(data))),
                      frac_bits)


def _tmpc(x: JMPCTensor) -> MPCTensor:
    return MPCTensor(ring.from_limbs(np.asarray(x.data.lo), np.asarray(x.data.hi),
                                     "cpu"), x.frac_bits)


def _smoke():
    """RESNET_SMOKE (the port's seeded weights), its reduced plan, the
    input shares of a batch of 2, the pool, in both packages."""
    params = resnet.init(RESNET_SMOKE, seed=0, device="cpu")

    def afn(p, v, relu_fn=None):
        return resnet.apply(p, v, RESNET_SMOKE, relu_fn=relu_fn)

    plan = api.trace_plan(afn, params, (2, 3, 8, 8), name="smoke")
    hb = api.HBConfig(tuple([api.HBLayer(k=21, m=13)] * (plan.n_groups - 1)
                            + [api.HBLayer(k=13, m=13)]), plan.group_elements)
    plan = plan.with_hb(hb)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, 8, 8)).astype(np.float32) * 0.5)
    X = MPCTensor.from_plain(prng.PRNGKey(2, "cpu"), x)
    pool = beaver.gen_plan_triples(prng.PRNGKey(3, "cpu"), plan.triple_specs())

    jparams = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), params)

    def jafn(p, v, relu_fn=None):
        return jresnet.apply(p, v, RESNET_SMOKE_J, relu_fn=relu_fn)

    jplan = japi.Plan.from_json(json.loads(json.dumps(plan.to_json())))
    assert jplan.digest() == plan.digest()
    return dict(afn=afn, params=params, plan=plan, X=X, pool=pool,
                jafn=jafn, jparams=jparams, jplan=jplan,
                jX=_jmpc(X.data, X.frac_bits),
                jpool=[_jbundle(b) for b in pool])


class _round_loop:
    """``HB_ROUND_LOOP`` set to ``mode`` inside the block."""

    def __init__(self, mode: str):
        self.mode = mode

    def __enter__(self):
        self.prev = os.environ.get("HB_ROUND_LOOP")
        os.environ["HB_ROUND_LOOP"] = self.mode

    def __exit__(self, *exc):
        if self.prev is None:
            os.environ.pop("HB_ROUND_LOOP", None)
        else:
            os.environ["HB_ROUND_LOOP"] = self.prev


def _jsim_run(s, session=None, loop="python"):
    """The reference's single-process run of ``s`` (its pool, key 4) on
    ``session`` (default: ``SimComm``)."""
    with _round_loop(loop):
        if session is None:
            session = japi.Session(key=0, provider=jbeaver.TriplePool(s["jpool"]))
        model = japi.compile(s["jafn"], s["jparams"], RESNET_SMOKE_J, s["jplan"],
                             session)
        return model(s["jX"], key=jax.random.PRNGKey(4)), session


@pytest.fixture(scope="module")
def smoke_ref():
    """The port's smoke inputs and the reference's ``SimComm`` output."""
    s = _smoke()
    want, _ = _jsim_run(s)
    s["want"] = _tmpc(want)
    return s


def _connected_party(ref, party, port, *, shaper=None, journal=None,
                     timeout_s=60.0):
    plan = ref["plan"]
    session = api.Session.connect(
        party,
        listen=(HOST, port) if party == 0 else None,
        peer=(HOST, port) if party == 1 else None,
        key=0, session_id="smoke-test", plan_digest=plan.digest(),
        provider=beaver.TriplePool(beaver.slice_party_pool(ref["pool"], party)),
        journal=journal, shaper=shaper, timeout_s=timeout_s,
        handshake_timeout_s=60.0, device="cpu")
    model = api.compile(ref["afn"], ref["params"], RESNET_SMOKE, plan, session)
    X = ref["X"]
    out = model(MPCTensor(X.data[party:party + 1], X.frac_bits),
                key=prng.PRNGKey(4, "cpu"))
    return out, session


# ---------------------------------------------------------------------------
# unit behaviour
# ---------------------------------------------------------------------------

def test_parse_address():
    assert parse_address("10.0.0.7:9100") == ("10.0.0.7", 9100)
    assert parse_address(":9100") == ("127.0.0.1", 9100)
    assert parse_address("example.org") == ("example.org", 9000)


def test_link_shaper_matches_schedule_pricing():
    from repro_torch.api.plan import NETWORKS
    wan = NETWORKS["wan"]
    shaper = LinkShaper.from_preset(wan)
    n = 4096
    assert shaper.round_delay(n) == pytest.approx(
        wan.rtt_s + 2 * n * 8 / wan.bandwidth_bps)
    assert LinkShaper().round_delay(1 << 20) == 0.0


def test_swap_roundtrip_and_byte_accounting():
    s0, s1 = _pair(session="s", plan="p", timeout_s=10.0)
    payload = {0: torch.arange(12, dtype=torch.int32).reshape(1, 3, 4),
               1: torch.ones((1, 3, 4), dtype=torch.int32)}
    ring_payload = {0: torch.full((1, 5), -7, dtype=torch.int64),
                    1: torch.arange(5, dtype=torch.int64).reshape(1, 5) << 40}
    try:
        g0, g1 = _run_parties(lambda: s0.swap(payload[0]),
                              lambda: s1.swap(payload[1]))
        assert torch.equal(g0, payload[1]) and torch.equal(g1, payload[0])
        r0, r1 = _run_parties(lambda: s0.swap(ring_payload[0]),
                              lambda: s1.swap(ring_payload[1]))
        assert torch.equal(r0, ring_payload[1]) and torch.equal(r1, ring_payload[0])
        # payload-exact accounting: 12 words, then 5 ring values (10 words);
        # envelopes tracked separately (1 HELLO + 2 DATA each so far)
        for s in (s0, s1):
            assert s.n_swaps == s.n_rounds == 2
            assert s.round_bytes == [12 * 4, 5 * 8]
            assert s.bytes_tx == 12 * 4 + 5 * 8
            assert s.header_bytes == 3 * 16
            assert s.negotiated["resume_round"] == 0
    finally:
        s0.close()
        s1.close()


def test_swap_larger_than_socket_buffers_does_not_deadlock():
    """Both parties send a 32 MB round at once, far past loopback's socket
    buffers: each swap sends on a helper thread while it receives, so
    neither blocks in its send (full-width ResNet-18's rounds reach tens of
    MB; a send-then-receive exchange stalls there until its timeout)."""
    s0, s1 = _pair(timeout_s=30.0)
    x0 = torch.arange(8 << 20, dtype=torch.int32).reshape(1, -1)
    x1 = x0.flip(1).contiguous()
    try:
        g0, g1 = _run_parties(lambda: s0.swap(x0), lambda: s1.swap(x1))
        assert torch.equal(g0, x1) and torch.equal(g1, x0)
        assert s0.round_bytes == s1.round_bytes == [32 << 20]
    finally:
        s0.close()
        s1.close()


def test_swap_rejects_wrong_dtype_and_party_dim():
    s0, s1 = _pair(timeout_s=5.0)
    try:
        with pytest.raises(TypeError, match="int32"):
            s0.swap(torch.zeros((1, 3), dtype=torch.int16))
        with pytest.raises(TypeError, match="party dim"):
            s0.swap(torch.zeros((2, 3), dtype=torch.int32))
        assert s0.party_is(0, torch.zeros(1, 4, 2)).shape == (1, 1, 1)
        assert bool(s1.party_is(1, torch.zeros(1, 4)).all())
        assert torch.equal(s1.party_slice(torch.arange(4).reshape(2, 2)),
                           torch.tensor([[2, 3]]))
    finally:
        s0.close()
        s1.close()


def _refused_handshake(host_kw, dial_kw, match):
    port = free_port()
    errs = {}

    def _host():
        try:
            SocketComm.host((HOST, port), party=0, timeout_s=5.0, **host_kw)
        except errors.HandshakeFailed as e:
            errs[0] = e

    t = threading.Thread(target=_host)
    t.start()
    with pytest.raises(errors.HandshakeFailed, match=match):
        SocketComm.dial((HOST, port), timeout_s=5.0, **dial_kw)
    t.join(WAIT_S)
    assert 0 in errs


def test_handshake_rejects_session_mismatch():
    _refused_handshake({"session": "alpha"}, {"party": 1, "session": "beta"},
                       "session mismatch")


def test_handshake_rejects_party_collision():
    _refused_handshake({}, {"party": 0}, "party")


def test_handshake_negotiates_journal_resume_round():
    port = free_port()
    out = {}

    def _host():
        out[0] = SocketComm.host((HOST, port), party=0, journal_len=7,
                                 timeout_s=5.0)

    t = threading.Thread(target=_host)
    t.start()
    out[1] = SocketComm.dial((HOST, port), party=1, journal_len=4, timeout_s=5.0)
    t.join(WAIT_S)
    s0, s1 = out[0], out[1]
    try:
        assert s0.negotiated["resume_round"] == 4
        assert s1.negotiated["resume_round"] == 4
        assert s0.negotiated["peer_journal_len"] == 4
        assert s1.negotiated["peer_journal_len"] == 7
    finally:
        s0.close()
        s1.close()


def test_idempotent_resend_dup_drop_and_recv_cache():
    """A local retry of an already-delivered round must not deadlock: the
    re-send is dropped by the peer as a stale dup and the local receive is
    served from the cache (the ResilientComm recovery contract)."""
    s0, s1 = _pair(timeout_s=10.0)
    x0 = torch.arange(6, dtype=torch.int32).reshape(1, 6)
    x1 = torch.arange(6, 12, dtype=torch.int32).reshape(1, 6)

    def party0():
        first = s0.swap(x0)
        s0._seq -= 1                     # simulate a ResilientComm retry
        again = s0.swap(x0)              # re-send + cached receive
        second = s0.swap(x0 + 100)
        return first, again, second

    def party1():
        a = s1.swap(x1)
        b = s1.swap(x1 + 100)            # receives the dup first: dropped
        return a, b

    try:
        (first, again, second), (a, b) = _run_parties(party0, party1)
        assert torch.equal(first, x1) and torch.equal(again, x1)
        assert torch.equal(second, x1 + 100) and torch.equal(b, x0 + 100)
        assert s1.dup_dropped == 1
        assert s0.n_swaps == 3           # the retry re-counts the round
    finally:
        s0.close()
        s1.close()


def test_resilient_comm_heals_real_socket_timeout():
    """Party 1's recv deadline is shorter than party 0's think time, so
    its first attempt times out mid-round; ResilientComm's idempotent
    re-send + the resumable receive buffer heal it without desyncing."""
    s0, s1 = _pair(timeout_s=10.0)
    s1._sock.settimeout(0.15)
    s1.timeout_s = 0.15
    r0 = comm_lib.ResilientComm(s0, max_retries=3)
    r1 = comm_lib.ResilientComm(s1, max_retries=10, backoff_s=0.01)
    x0 = torch.arange(8, dtype=torch.int32).reshape(1, 8)
    x1 = torch.arange(8, 16, dtype=torch.int32).reshape(1, 8)

    def party0():
        time.sleep(0.6)                  # stall past party 1's deadline
        return r0.swap(x0)

    try:
        g0, g1 = _run_parties(party0, lambda: r1.swap(x1))
        assert torch.equal(g0, x1) and torch.equal(g1, x0)
        assert r1.retries >= 1
        assert r1.recovered == 1
        assert r1.faults_detected["timeout"] >= 1
    finally:
        s0.close()
        s1.close()


def test_injected_drop_heals_under_session_stack():
    """A FaultInjectingComm drop between the socket and ResilientComm (a
    lost send attempt) is healed by the retry budget; both parties finish
    with identical transcripts."""
    s0, s1 = _pair(timeout_s=10.0)
    plan = faults_lib.FaultPlan((faults_lib.FaultEvent(round=1, kind="drop"),))
    r0 = comm_lib.ResilientComm(faults_lib.FaultInjectingComm(plan, s0),
                                max_retries=3, backoff_s=0.0)
    r1 = comm_lib.ResilientComm(s1, max_retries=3)

    def run(r, base):
        return [r.swap(torch.full((1, 4), base + i, dtype=torch.int32))
                for i in range(3)]

    try:
        g0, g1 = _run_parties(lambda: run(r0, 100), lambda: run(r1, 200))
        for i in range(3):
            assert bool((g0[i] == 200 + i).all())
            assert bool((g1[i] == 100 + i).all())
        assert r0.retries == 1 and r0.recovered == 1
    finally:
        s0.close()
        s1.close()


# ---------------------------------------------------------------------------
# full-stack parity (threads): Session.connect + ResNet smoke inference
# ---------------------------------------------------------------------------

def _combined(out0, out1) -> torch.Tensor:
    return torch.cat([out0.data, out1.data])


def test_socket_inference_bit_identical_and_bytes_framed(smoke_ref):
    """The two-party socket run reproduces the reference's SimComm run
    bit-identically on the same shares/triples, and the measured wire
    bytes equal the framed schedule prediction exactly, round for round."""
    port = free_port()
    (out0, sess0), (out1, sess1) = _run_parties(
        lambda: _connected_party(smoke_ref, 0, port),
        lambda: _connected_party(smoke_ref, 1, port))
    try:
        assert torch.equal(_combined(out0, out1), smoke_ref["want"].data)
        framed = smoke_ref["plan"].schedule().framed()
        for sess in (sess0, sess1):
            sock = sess.transport
            assert sock.n_swaps == framed.n_rounds
            assert sock.round_bytes == list(framed.round_bytes)
            resilient = comm_lib.find_resilient(sess.comm)
            assert resilient.round_bytes == list(framed.round_bytes)
    finally:
        sess0.transport.close()
        sess1.transport.close()


def test_socket_wall_clock_within_schedule_band_under_injected_rtt(smoke_ref):
    """Under an injected RTT the measured wall-clock is bounded below by
    the schedule's latency prediction (the shaper paces each round to
    exactly the predicted per-round cost) and above by a generous
    compute-inclusive band."""
    rtt_s = 0.004
    shaper = LinkShaper(rtt_s=rtt_s)
    framed = smoke_ref["plan"].schedule().framed()
    predicted = framed.latency(float("inf"), rtt_s)
    port = free_port()
    t0 = time.monotonic()
    (out0, sess0), (out1, sess1) = _run_parties(
        lambda: _connected_party(smoke_ref, 0, port, shaper=shaper),
        lambda: _connected_party(smoke_ref, 1, port, shaper=shaper))
    wall = time.monotonic() - t0
    try:
        assert predicted > 0
        assert wall >= predicted, (wall, predicted)
        assert wall <= 20 * predicted + 30.0, (wall, predicted)
        assert torch.equal(_combined(out0, out1), smoke_ref["want"].data)
    finally:
        sess0.transport.close()
        sess1.transport.close()


# ---------------------------------------------------------------------------
# deployment: two OS processes via launch/party_host + a job directory
# ---------------------------------------------------------------------------

def _write_smoke_job(job_dir, ref):
    write_job(job_dir, plan=ref["plan"], config="smoke", params_seed=0,
              infer_key=4, session_seed=0, x=ref["X"], pool=ref["pool"])


def _spawn_party(job_dir, party, port, *extra):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    link = (["--listen", f"{HOST}:{port}"] if party == 0
            else ["--peer", f"{HOST}:{port}"])
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.party_host",
         "--party", str(party), "--job", str(job_dir), "--device", "cpu",
         *link, *extra],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _wait(procs, timeout_s=WAIT_S):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout_s)
            outs.append((p.returncode, out, err))
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.communicate()
    return outs


def _combined_out(job_dir) -> torch.Tensor:
    rows = []
    for p in (0, 1):
        with np.load(os.path.join(job_dir, f"out{p}.npz")) as z:
            rows.append(ring.from_limbs(z["lo"], z["hi"], "cpu"))
    return torch.cat(rows)


def test_two_process_inference_bit_identical_to_sim(smoke_ref, tmp_path):
    """Two OS processes complete a private ResNet inference over localhost
    TCP, bit-identical to the reference's SimComm run on the same
    shares/triples, with wire bytes equal to the framed schedule on both
    sides; the params are each process's own seeded init, the same in
    both, and the same as the fixture's."""
    jobdir = tmp_path / "job"
    _write_smoke_job(jobdir, smoke_ref)
    port = free_port()
    res = _wait([_spawn_party(jobdir, 0, port), _spawn_party(jobdir, 1, port)])
    for rc, out, err in res:
        assert rc == 0, (rc, out[-2000:], err[-4000:])
    assert torch.equal(_combined_out(jobdir), smoke_ref["want"].data)
    framed = smoke_ref["plan"].schedule().framed()
    for p in (0, 1):
        stats = json.loads((jobdir / f"stats{p}.json").read_text())
        assert stats["rounds"] == framed.n_rounds
        assert stats["payload_bytes"] == framed.bytes_tx
        assert stats["replayed"] == 0
        assert stats["retries"] == 0
        assert set(stats) == {"party", "rounds", "payload_bytes", "header_bytes",
                              "dup_dropped", "retries", "recovered", "replayed",
                              "resume_round", "wall_s", "shaped"}


def test_kill_party_mid_run_then_journal_resume(smoke_ref, tmp_path):
    """Party 0 is hard-killed (os._exit, no cleanup) after 5 live rounds;
    party 1 exits with the restart code; both relaunch with the same
    arguments and resume from their journals, replaying the negotiated
    common prefix without touching the wire, and the final outputs are
    bit-identical to an uninterrupted run."""
    jobdir = tmp_path / "job"
    _write_smoke_job(jobdir, smoke_ref)
    j0, j1 = str(tmp_path / "j0"), str(tmp_path / "j1")
    port = free_port()
    res = _wait([_spawn_party(jobdir, 0, port, "--journal", j0,
                              "--die-after-round", "5"),
                 _spawn_party(jobdir, 1, port, "--journal", j1)])
    assert res[0][0] == 42, res[0]            # the simulated kill -9
    assert res[1][0] == 17, res[1]            # restartable peer-crash exit

    port = free_port()
    res = _wait([_spawn_party(jobdir, 0, port, "--journal", j0),
                 _spawn_party(jobdir, 1, port, "--journal", j1)])
    for rc, out, err in res:
        assert rc == 0, (rc, out[-2000:], err[-4000:])
    assert torch.equal(_combined_out(jobdir), smoke_ref["want"].data)
    framed = smoke_ref["plan"].schedule().framed()
    for p in (0, 1):
        stats = json.loads((jobdir / f"stats{p}.json").read_text())
        assert stats["resume_round"] == 5
        assert stats["replayed"] == 5
        assert stats["rounds"] == framed.n_rounds - 5


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def test_reference_and_port_sockets_handshake_and_exchange():
    """A reference SocketComm hosts, a port SocketComm dials: the HELLO
    and a DATA round (words one way, ring limbs the other) pass between
    the packages byte for byte, in both counters."""
    port = free_port()
    out = {}

    def _host():
        out[0] = JSocketComm.host((HOST, port), party=0, session="x", plan="d",
                                  journal_len=3, timeout_s=10.0)

    t = threading.Thread(target=_host)
    t.start()
    out[1] = SocketComm.dial((HOST, port), party=1, session="x", plan="d",
                             journal_len=5, timeout_s=10.0)
    t.join(WAIT_S)
    js, ts = out[0], out[1]
    ring_vals = (torch.arange(6, dtype=torch.int64).reshape(1, 6) << 33) - 5
    words = np.arange(12, dtype=np.uint32).reshape(1, 12) * np.uint32(2654435761)
    try:
        assert js.negotiated["resume_round"] == ts.negotiated["resume_round"] == 3
        got_j, got_t = _run_parties(lambda: js.swap(jnp.asarray(words)),
                                    lambda: ts.swap(ring_vals))
        lo, hi = ring.to_limbs(ring_vals)
        np.testing.assert_array_equal(np.asarray(got_j),
                                      np.concatenate([lo, hi], axis=1))
        assert torch.equal(ring.from_limbs(words[:, :6], words[:, 6:], "cpu"), got_t)
        assert js.round_bytes == ts.round_bytes == [48]
        assert js.header_bytes == ts.header_bytes == 32
    finally:
        js.close()
        ts.close()


def test_jax_party_and_torch_party_smoke_inference(smoke_ref):
    """One reference party (party 0) and one port party (party 1) run the
    smoke ResNet over their own ``Session.connect`` stacks in two threads:
    the combined output equals the reference's SimComm run, and both
    sides' framed bytes equal the schedule's."""
    s = smoke_ref
    port = free_port()

    def jax_party():
        with _round_loop("python"):
            session = japi.Session.connect(
                0, listen=(HOST, port), key=0, session_id="smoke-test",
                plan_digest=s["jplan"].digest(),
                provider=jbeaver.TriplePool(jbeaver.slice_party_pool(s["jpool"], 0)),
                timeout_s=WAIT_S, handshake_timeout_s=60.0)
            model = japi.compile(s["jafn"], s["jparams"], RESNET_SMOKE_J,
                                 s["jplan"], session)
            jX = s["jX"]
            x0 = JMPCTensor(jring.Ring64(jX.data.lo[:1], jX.data.hi[:1]),
                            jX.frac_bits)
            return model(x0, key=jax.random.PRNGKey(4)), session

    (jout, jsess), (tout, tsess) = _run_parties(
        jax_party, lambda: _connected_party(s, 1, port, timeout_s=WAIT_S))
    try:
        got = torch.cat([_tmpc(jout).data, tout.data])
        assert torch.equal(got, s["want"].data)
        framed = s["plan"].schedule().framed()
        for sock in (jsess.transport, tsess.transport):
            assert sock.n_swaps == framed.n_rounds
            assert list(sock.round_bytes) == list(framed.round_bytes)
    finally:
        jsess.transport.close()
        tsess.transport.close()


def _same_party_view(a, b):
    assert torch.equal(a["X"].data, b["X"].data) and a["X"].frac_bits == b["X"].frac_bits
    assert len(a["pool"]) == len(b["pool"])
    for x, y in zip(a["pool"], b["pool"]):
        assert (x is None) == (y is None)
        if x is not None:
            assert all(torch.equal(u, v) for u, v in
                       zip(beaver.relu_tensors(x), beaver.relu_tensors(y)))


def test_job_directories_load_across_packages(smoke_ref, tmp_path):
    """A job directory written by either package's ``write_job`` loads in
    the other's ``load_party`` to identical shares and pool leaves (the
    reference's leaves carried to the port for the comparison)."""
    s = smoke_ref
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    _write_smoke_job(port_dir, s)
    jjob.write_job(ref_dir, plan=s["jplan"], config="smoke", params_seed=0,
                   infer_key=4, session_seed=0, x=s["jX"], pool=s["jpool"])
    for p in (0, 1):
        mine = job.load_party(port_dir, p, device="cpu")
        theirs = job.load_party(ref_dir, p, device="cpu")
        _same_party_view(mine, theirs)
        assert torch.equal(mine["X"].data, s["X"].data[p:p + 1])
        want = beaver.slice_party_pool(s["pool"], p)
        _same_party_view(mine, {"X": mine["X"], "pool": want})
        if p == 0:
            continue
        # the reference loads the port's directory to the same leaves
        jview = jjob.load_party(str(port_dir), p)
        assert jview["plan"].digest() == s["plan"].digest()
        assert torch.equal(_tmpc(jview["X"]).data, mine["X"].data)
        jleaves = jax.tree_util.tree_leaves(jview["pool"])
        tleaves = jax.tree_util.tree_leaves(
            jbeaver.slice_party_pool(s["jpool"], p))
        assert len(jleaves) == len(tleaves)
        for u, v in zip(jleaves, tleaves):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
        with np.load(port_dir / f"party{p}.npz") as a, \
                np.load(ref_dir / f"party{p}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype == np.uint32
                np.testing.assert_array_equal(a[k], b[k])
    assert json.loads((port_dir / "job.json").read_text()) == \
        json.loads((ref_dir / "job.json").read_text())
    assert (port_dir / "plan.json").read_text() == (ref_dir / "plan.json").read_text()


@pytest.mark.parametrize("cone", [False, True])
def test_pool_treedef_matches_generated_bundles(cone):
    """``pool_treedef`` (shapes only) gives each generated, party-sliced
    bundle's leaves in order, shapes and dtypes, at every width class
    (w = 1, where the dense stack still holds one level; ragged cone
    levels; culled calls)."""
    class _Plan:
        def triple_specs(self):
            return [(n, w) for n in (1, 31, 100) for w in (0, 1, 2, 3, 8, 21, 64)]

    plan = _Plan()
    plan.cone = cone
    real = beaver.slice_party_pool(beaver.gen_plan_triples(
        prng.PRNGKey(0, "cpu"), plan.triple_specs(), cone=cone), 1)
    for tmpl, bundle in zip(job.pool_treedef(plan), real, strict=True):
        assert (tmpl is None) == (bundle is None)
        if bundle is not None:
            assert type(tmpl.bin_levels) is type(bundle.bin_levels)
            assert [(t.shape, t.dtype) for t in beaver.relu_tensors(tmpl)] == \
                [(t.shape, t.dtype) for t in beaver.relu_tensors(bundle)]


def test_party_sliced_ttp_slices_a_materialising_provider():
    """``PartySlicedTTP`` keeps one party's rows of the base provider's
    bundles (dense and cone), consumes nothing on culled calls, rolls back
    with its base, and refuses an inline base (which would derive
    triples from a one-row layout)."""
    for cone in (False, True):
        full = beaver.StreamingTTP(prng.PRNGKey(5, "cpu"))
        sliced = beaver.PartySlicedTTP(beaver.StreamingTTP(prng.PRNGKey(5, "cpu")), 1)
        assert sliced.relu_triples(100, 0) is None
        token = sliced.checkpoint()
        for _ in range(2):
            want = beaver.slice_party_bundle(full.relu_triples(100, 8, cone=cone), 1)
            got = sliced.relu_triples(100, 8, cone=cone)
            assert all(torch.equal(u, v) for u, v in
                       zip(beaver.relu_tensors(got), beaver.relu_tensors(want)))
            assert all(t.shape[0] == 1 for t in (got.bin_init.a, got.b2a.a))
        sliced.rollback(token)
        again = sliced.relu_triples(100, 8, cone=cone)
        first = beaver.slice_party_bundle(beaver.StreamingTTP(
            prng.PRNGKey(5, "cpu")).relu_triples(100, 8, cone=cone), 1)
        assert torch.equal(again.mult.c, first.mult.c)
    with pytest.raises(TypeError, match="materialising"):
        beaver.PartySlicedTTP(beaver.InlineTTP(), 0).relu_triples(100, 8)
