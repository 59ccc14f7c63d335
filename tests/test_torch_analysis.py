"""The port's protocol-safety gate (``repro_torch.analysis``) against the
reference's (``repro.analysis``): per-rule lint fixtures (on the fixtures
that mean the same in both packages, the same rule ids on the same lines
as the reference's linter), the torch additions of each rule, suppression
and baseline, the repo self-check, the lock checker on the port's engine
and frontend, census units on hand-built round generators, the canonical
CPU census, the CLI, and the ``Plan.validate`` pre-flight cases.

Every fixture source is a string: the reference's own self-check lints
this file too."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.analysis import lint as jlint, locks as jlocks
from repro_torch import errors
from repro_torch.analysis import census, hbcheck, lint, locks
from repro_torch.api.plan import Plan, ReluCall
from repro_torch.core import beaver, fixed, gmw, prng, schedule, shares
from repro_torch.core.hummingbird import HBConfig, HBLayer

ROOT = pathlib.Path(__file__).resolve().parent.parent

CORE = "src/repro_torch/core/newmod.py"       # scoped like a protocol module
API = "src/repro_torch/api/newmod.py"         # inside the reveal surface
TESTS = "tests/test_torch_newmod.py"          # exempt from most rules


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small integer ops: as fast on one thread, and no crowding of
    the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rules(findings):
    return [f.rule for f in findings]


def _lint(src, path):
    return lint.lint_source(textwrap.dedent(src), path)


def _same_as_reference(src, path):
    """The port's findings on ``path`` and the reference's on its twin
    path: the same rule ids on the same lines.  Returns the port's."""
    mine = _lint(src, path)
    theirs = jlint.lint_source(textwrap.dedent(src),
                               path.replace("src/repro_torch/", "src/repro/"))
    assert [(f.rule, f.line) for f in mine] == [(f.rule, f.line) for f in theirs]
    return mine


# ---------------------------------------------------------------------------
# R001 raw exchange outside the comm seam
# ---------------------------------------------------------------------------

def test_r001_flags_raw_swap_outside_seam():
    src = """
    def f(comm, payload):
        return comm.swap(payload)
    """
    assert _rules(_lint(src, CORE)) == ["R001"]
    assert _rules(_lint(src, "src/repro_torch/serve/engine.py")) == ["R001"]


def test_r001_allows_seam_and_tests_and_generator_send():
    src = """
    def f(comm, payload):
        return comm.swap(payload)
    """
    for ok in ("src/repro_torch/core/comm.py", "src/repro_torch/core/gmw.py",
               "src/repro_torch/launch/mesh.py", TESTS):
        assert _lint(src, ok) == [], ok
    # drive()'s generator .send() is not a wire primitive
    assert _lint("""
    def drive(gen, comm):
        gen.send(None)
    """, CORE) == []


@pytest.mark.parametrize("line", [
    "dist.isend(t, 1)",
    "dist.irecv(t, 1)",
    "dist.batch_isend_irecv([op])",
    "dist.send(t, 1)",
    "dist.recv(t, 1)",
    "dist.broadcast(t, 0)",
    "dist.all_reduce(t)",
    "dist.all_gather_into_tensor(t, t)",
    "dist.all_gather_object([None], t)",
    "dist.all_to_all_single(t, t)",
    "dist.gather(t, [t], dst=0)",
    "dist.P2POp(dist.isend, t, 1)",
    "torch.distributed.all_reduce(t)",
])
def test_r001_flags_torch_distributed_primitives(line):
    src = f"""
    import torch
    import torch.distributed as dist
    def f(t, op):
        {line}
    """
    assert _rules(_lint(src, CORE)) == ["R001"], line
    assert _rules(_lint(src, "src/repro_torch/api/compile.py")) == ["R001"]
    assert _lint(src, "src/repro_torch/core/comm.py") == []
    assert _lint(src, "src/repro_torch/launch/mesh.py") == []
    assert _lint(src, TESTS) == []


def test_r001_torch_distributed_through_imported_names_and_lookalikes():
    flagged = """
    from torch.distributed import isend as send_now
    def f(t):
        return send_now(t, 1)
    """
    assert _rules(_lint(flagged, CORE)) == ["R001"]
    # torch.gather, numpy's broadcast and a generator's send move nothing
    assert _lint("""
    import numpy as np
    import torch
    def f(t, idx, gen):
        gen.send(None)
        np.broadcast(t, t)
        return torch.gather(t, 0, idx)
    """, CORE) == []


# ---------------------------------------------------------------------------
# R002 reveal surface
# ---------------------------------------------------------------------------

def test_r002_flags_reveal_outside_surface():
    src = """
    def f(x):
        return x.reveal()
    """
    assert _rules(_same_as_reference(src, CORE)) == ["R002"]


def test_r002_allows_api_serve_launch_and_share_types():
    src = """
    def f(x):
        return x.reveal_np()
    """
    for ok in (API, "src/repro_torch/serve/frontend.py",
               "src/repro_torch/launch/party_host.py",
               "src/repro_torch/core/mpc_tensor.py", TESTS):
        assert _same_as_reference(src, ok) == [], ok


# ---------------------------------------------------------------------------
# R003 secret-dependent control flow
# ---------------------------------------------------------------------------

def test_r003_flags_branch_on_annotated_share():
    src = """
    def f(x: MPCTensor):
        if x:
            return 1
    """
    assert _rules(_same_as_reference(src, API)) == ["R003"]


def test_r003_flags_branch_on_constructed_share_and_while():
    src = """
    def f(key, v):
        x = MPCTensor(v)
        while x.data:
            pass
    """
    assert _rules(_same_as_reference(src, API)) == ["R003"]


def test_r003_allows_metadata_none_checks_and_reveal():
    src = """
    def f(x: MPCTensor):
        if x is None:
            return 0
        if x.shape[0] > 1:
            pass
        if isinstance(x, tuple):
            pass
        y = x.reveal()
        if y > 0:
            return 1
    """
    assert _same_as_reference(src, API) == []


def test_r003_reassignment_clears_taint():
    src = """
    def f(v):
        x = MPCTensor(v)
        x = 3
        if x:
            return 1
    """
    assert _same_as_reference(src, API) == []


@pytest.mark.parametrize("test", [
    "if x.data.sum().item() > 0:",
    "if x.data.tolist()[0]:",
    "if bool(x.data.any()):",
    "if int(x.data[0, 0]):",
    "while torch.equal(x.data[0], x.data[1]):",
    "if shares.share(key, v).any():",
])
def test_r003_flags_host_syncs_on_shares(test):
    src = f"""
    import torch
    def f(x: MPCTensor, key, v):
        {test}
            pass
    """
    assert _rules(_lint(src, CORE)) == ["R003"], test
    assert _rules(_lint("""
    def f(x: MPCTensor):
        return 1 if x.data.sum().item() else 0
    """, CORE)) == ["R003"]


def test_r003_allows_torch_metadata_and_per_sequence_loop_targets():
    src = """
    def f(x: MPCTensor, tensors: list, kinds, hbs):
        if x.device.type == "cuda" or x.data.numel() > 4 or x.data.dim() == 2:
            pass
        if x.data.dtype == torch.int64 and x.data.size(0) == 2:
            pass
        for i, (t, kind, hb) in enumerate(zip(x.data, kinds, hbs)):
            if kind == "mul" or hb.is_identity or i:
                pass
            if t.any():
                pass
    """
    # only the branch on ``t`` (an element of the share) is secret
    assert [(f.rule, f.line) for f in _lint(src, CORE)] == [("R003", 10)]


# ---------------------------------------------------------------------------
# R004 PRNG discipline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    "prng.PRNGKey(0)",
    "prng.PRNGKey(3, 'cuda')",
    "torch.manual_seed(0)",
    "torch.cuda.manual_seed(7)",
    "torch.Generator().manual_seed(5)",
    "torch.Generator(device='cuda').manual_seed(5)",
])
def test_r004_flags_constant_seed_outside_tests(call):
    src = f"""
    import torch
    from repro_torch.core import prng
    def f():
        return {call}
    """
    assert _rules(_lint(src, CORE)) == ["R004"], call
    assert _rules(_lint(src, "src/repro_torch/search/engine.py")) == ["R004"]
    assert _lint(src, TESTS) == []


def test_r004_allows_variable_seeds():
    src = """
    import torch
    def f(seed):
        g = torch.Generator().manual_seed(seed + 1)
        return prng.PRNGKey(seed), g
    """
    assert _lint(src, CORE) == []


def test_r004_suppression_comment():
    src = """
    def f():
        return prng.PRNGKey(0)  # hbcheck: disable=R004 -- a documented fixture
    """
    assert _lint(src, CORE) == []
    src = """
    def f():
        # hbcheck: disable=R004,R001 -- the line above counts too
        return prng.PRNGKey(0)
    """
    assert _lint(src, CORE) == []


@pytest.mark.parametrize("draw", [
    "torch.rand(4)", "torch.rand_like(t)", "torch.randn(4)",
    "torch.randint(0, 9, (4,))", "torch.randperm(4)", "torch.bernoulli(t)",
    "torch.normal(t, 1.0)", "torch.multinomial(t, 2)", "t.uniform_()",
    "t.random_()", "t.normal_()",
])
def test_r004_flags_global_generator_draws_in_protocol_modules(draw):
    src = f"""
    import torch
    def f(t):
        return {draw}
    """
    for mod in (CORE, "src/repro_torch/serve/engine.py",
                "src/repro_torch/kernels/ops.py",
                "src/repro_torch/nn/approx/pwl.py"):
        assert _rules(_lint(src, mod)) == ["R004"], (draw, mod)
    # float model code (weights, data) may use the global generator
    assert _lint(src, "src/repro_torch/search/finetune.py") == []


def test_r004_allows_seeded_generators_and_session_keys():
    src = """
    import torch
    from repro_torch.core import prng
    def f(t, gen, key):
        a = torch.randint(0, 9, (4,), generator=gen)
        b = t.uniform_(generator=gen)
        return a, b, prng.normal(key, (4,)), prng.bits(key, (4,))
    """
    assert _lint(src, CORE) == []


# ---------------------------------------------------------------------------
# R005 ring dtype discipline
# ---------------------------------------------------------------------------

def test_r005_flags_float_and_division_in_ring_modules():
    src = """
    import torch
    def f(a, b):
        c = a.to(torch.float32)
        return c / b
    """
    assert _rules(_same_as_reference(src, "src/repro_torch/core/ring.py")) == [
        "R005", "R005"]
    # same code outside the ring modules is not R005's business
    assert _same_as_reference(src, "src/repro_torch/search/engine.py") == []


def test_r005_allows_integer_ring_ops():
    src = """
    import torch
    def f(a, b):
        c = a.to(torch.int64)
        return (c // 2) + (b >> 1) + torch.div(a, 4, rounding_mode="floor")
    """
    assert _same_as_reference(src, "src/repro_torch/core/ring.py") == []


@pytest.mark.parametrize("expr", [
    "a.float()", "a.double()", "a.half()", "a.to(torch.bfloat16)",
    "torch.zeros(3, dtype=float)", "torch.true_divide(a, b)", "torch.div(a, b)",
    "a.to(torch.half)",
])
def test_r005_flags_torch_float_forms(expr):
    src = f"""
    import torch
    def f(a, b):
        return {expr}
    """
    for mod in ("core/ring.py", "core/ring_linalg.py", "core/gmw.py",
                "core/gmw_ref.py", "core/shares.py"):
        assert _rules(_lint(src, f"src/repro_torch/{mod}")) == ["R005"], (expr, mod)
    assert _lint(src, "src/repro_torch/core/fixed.py") == []


def test_r005_flags_in_place_true_division():
    assert _rules(_lint("""
    def f(a, b):
        a /= b
        return a
    """, "src/repro_torch/core/gmw.py")) == ["R005"]


# ---------------------------------------------------------------------------
# R006 round-path determinism
# ---------------------------------------------------------------------------

def test_r006_flags_wall_clock_stdlib_random_and_set_iteration():
    src = """
    import os
    import random
    import time
    def f(groups):
        t = time.time()
        r = random.random()
        u = os.urandom(4)
        for g in {1, 2}:
            pass
        return t, r, u
    """
    assert _rules(_same_as_reference(src, "src/repro_torch/core/schedule.py")) == [
        "R006", "R006", "R006", "R006"]
    # off the round path the same code is fine
    assert _same_as_reference(src, "src/repro_torch/search/engine.py") == []


def test_r006_allows_monotonic_and_sorted_iteration():
    src = """
    import time
    def f(groups):
        t = time.monotonic()
        for g in sorted(groups):
            pass
        return t
    """
    assert _same_as_reference(src, "src/repro_torch/core/comm.py") == []


def test_r006_covers_the_mapped_round_path_and_the_port_prng():
    src = """
    import time
    def f():
        return time.time()
    """
    for mod in ("nn/approx/pwl.py", "nn/approx/attention.py",
                "nn/approx/bounds.py", "nn/approx/__init__.py",
                "core/gmw.py", "core/beaver.py", "transport/socket.py"):
        path = f"src/repro_torch/{mod}"
        assert _rules(_same_as_reference(src, path)) == ["R006"], mod
    # the port's threefry has no twin (the reference takes jax.random)
    assert _rules(_lint(src, "src/repro_torch/core/prng.py")) == ["R006"]
    # a set comprehension's iteration is flagged too (and does not crash)
    assert _rules(_lint("""
    def f(xs):
        return [x for x in set(xs)]
    """, "src/repro_torch/core/prng.py")) == ["R006"]
    # sibling nn modules stay off the round path
    assert _same_as_reference(src, "src/repro_torch/nn/common.py") == []


def test_r002_r003_apply_inside_nn_approx():
    assert _rules(_same_as_reference("""
    def f(x):
        return x.reveal()
    """, "src/repro_torch/nn/approx/pwl.py")) == ["R002"]
    assert _rules(_same_as_reference("""
    def f(x: MPCTensor):
        if x:
            return 1
    """, "src/repro_torch/nn/approx/attention.py")) == ["R003"]


# ---------------------------------------------------------------------------
# baseline machinery and the repo self-check
# ---------------------------------------------------------------------------

def test_baseline_roundtrip_filters_findings(tmp_path):
    src = """
    def f(comm, p):
        return comm.swap(p)
    """
    findings = _lint(src, CORE)
    assert len(findings) == 1
    bl = tmp_path / "baseline.json"
    lint.save_baseline(bl, findings)
    baseline = lint.load_baseline(bl)
    assert all(f.key() in baseline for f in findings)
    assert lint.load_baseline(tmp_path / "missing.json") == set()


def test_port_is_clean_of_lint_and_lock_findings():
    """The port's self-check: its package, tests, chip_smoke.py and tools
    carry no finding, and its baseline is empty."""
    paths = hbcheck.default_paths(ROOT)
    assert str(ROOT / "src" / "repro_torch") in paths
    assert str(ROOT / "chip_smoke.py") in paths
    findings = lint.lint_paths(paths, root=ROOT) + locks.check_paths(ROOT)
    baseline = lint.load_baseline(ROOT / hbcheck.DEFAULT_BASELINE)
    assert baseline == set()
    assert findings == [], "\n".join(str(f) for f in findings)


def test_analysis_package_imports_neither_jax_nor_reference():
    import ast

    files = sorted((ROOT / "src" / "repro_torch" / "analysis").glob("*.py"))
    assert {f.name for f in files} >= {"lint.py", "locks.py", "census.py",
                                       "hbcheck.py", "__init__.py"}
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            assert not [n for n in names
                        if n.split(".")[0] in ("jax", "jaxlib", "repro")], f


# ---------------------------------------------------------------------------
# lock discipline
# ---------------------------------------------------------------------------

_LOCKY = textwrap.dedent("""
    import threading

    class InferenceEngine:
        def __init__(self):
            self._lock = threading.RLock()
            self._queue = []

        def ok(self):
            with self._lock:
                return len(self._queue)

        def bad(self):
            return len(self._queue)

        def _helper(self):
            self._queue.append(1)

        def caller(self):
            with self._lock:
                self._helper()

        def deferred(self):
            with self._lock:
                def peek():
                    return len(self._queue)
                return peek
""")


def _tuples(findings):
    return [(f.file, f.line, f.rule, f.message) for f in findings]


def test_lock_checker_flags_unguarded_and_deferred_access():
    findings = locks.check_lock_discipline(_LOCKY, "engine.py")
    methods = {f.message.split()[0] for f in findings}
    # bad() reads without the lock; the closure in deferred() may run
    # after the lock is released; _helper is lock-held via its call site
    assert methods == {"InferenceEngine.bad", "InferenceEngine.deferred"}
    assert _tuples(findings) == _tuples(jlocks.check_lock_discipline(_LOCKY,
                                                                     "engine.py"))


def _engine_source():
    return (ROOT / "src" / "repro_torch" / "serve" / "engine.py").read_text()


def test_lock_checker_real_engine_is_clean():
    assert locks.check_lock_discipline(_engine_source(), "engine.py") == []
    assert {"watchdog", "comm", "reports", "_queue"} <= locks.ENGINE_SPEC.guarded


def test_lock_checker_regression_on_injected_unguarded_access():
    """Deliberately add an unguarded pump-state access to the port's
    engine source: the checker must catch exactly the injection."""
    src = _engine_source()
    injected = src.replace(
        "    def stats(",
        "    def sneak_peek(self):\n"
        "        return len(self._queue)\n\n"
        "    def stats(", 1)
    assert injected != src
    findings = locks.check_lock_discipline(injected, "engine.py")
    assert len(findings) == 1
    assert "sneak_peek" in findings[0].message
    assert "_queue" in findings[0].message


def test_stats_reads_the_watchdog_under_the_lock():
    """``stats`` read ``self.watchdog.stragglers`` after its locked block,
    while the pump appends to it under the lock: the form it had is
    flagged, and the engine reports the slow batches it counted."""
    src = _engine_source()
    old = src.replace('"slow_batches": slow,',
                      '"slow_batches": len(self.watchdog.stragglers),', 1)
    assert old != src
    findings = locks.check_lock_discipline(old, "engine.py")
    assert [(f.rule, "InferenceEngine.stats" in f.message, "watchdog" in f.message)
            for f in findings] == [("L001", True, True)]

    from repro_torch.serve.engine import InferenceEngine

    engine = InferenceEngine.__new__(InferenceEngine)
    import threading
    from repro_torch.runtime.watchdog import StragglerWatchdog

    engine._lock = threading.RLock()
    engine.reports = []
    engine._totals = {"serial_rounds": 0, "fused_rounds": 0}
    engine.watchdog = StragglerWatchdog(factor=2.0, warmup=0)
    for tag, dt in enumerate((1.0, 1.0, 9.0)):
        engine.watchdog.observe(tag, dt)
    assert engine.stats()["slow_batches"] == 1


def test_private_reach_flags_engine_internals():
    src = textwrap.dedent("""
        class Frontend:
            def peek(self):
                return len(self.engine._queue)

            def fine(self):
                return self.engine.pending
    """)
    findings = locks.check_private_reach(src, "frontend.py")
    assert len(findings) == 1 and "_queue" in findings[0].message
    assert _tuples(findings) == _tuples(jlocks.check_private_reach(src, "frontend.py"))


def test_private_reach_real_frontend_is_clean():
    src = (ROOT / "src" / "repro_torch" / "serve" / "frontend.py").read_text()
    assert locks.check_private_reach(src, "frontend.py") == []
    assert locks.check_paths(ROOT) == []


# ---------------------------------------------------------------------------
# census on hand-built round generators
# ---------------------------------------------------------------------------

def _words(seed, n=64, dtype=torch.int32):
    g = torch.Generator().manual_seed(seed)
    lo, hi = (-2 ** 31, 2 ** 31) if dtype == torch.int32 else (-2 ** 63, 2 ** 63 - 1)
    return torch.randint(lo, hi, (2, n), generator=g, dtype=dtype)


def _census(*gens, dtype=torch.int32):
    """The census of round generators ``gen(x, r)`` run as sibling streams:
    x the secret shares, r the masks."""
    def run(comm, x, r):
        return gmw.run_streams(comm, [g(x, r) for g in gens])

    return census.leakage_census(run, _words(1, dtype=dtype), _words(2, dtype=dtype),
                                 _words(3, dtype=dtype),
                                 lambda i: _words(10 + i, dtype=dtype))


def _masked(x, r):
    yield x ^ r


def _raw(x, r):
    yield x


def test_census_masked_payload_is_masked():
    (rnd,) = _census(_masked)
    assert rnd.kind == "masked"
    assert (rnd.elements, rnd.secret, rnd.masked, rnd.unmasked) == (128, 128, 128, 0)
    assert rnd.bytes == 64 * 4
    # pure mask material (the A2B round's r) is masked, not secret
    (rnd,) = _census(lambda x, r: (yield r))
    assert (rnd.kind, rnd.secret, rnd.masked) == ("masked", 0, 128)


@pytest.mark.parametrize("how", ["one payload", "two streams"])
def test_census_raw_share_next_to_masked_is_unmasked(how):
    if how == "one payload":
        rounds = _census(lambda x, r: (yield torch.cat([x ^ r, x], dim=1)))
    else:
        rounds = _census(_masked, _raw)
    (rnd,) = rounds
    assert rnd.kind == "unmasked"
    assert (rnd.elements, rnd.unmasked, rnd.masked) == (256, 128, 128)


def test_census_constant_payload_is_public():
    (rnd,) = _census(lambda x, r: (yield torch.zeros_like(x)))
    assert (rnd.kind, rnd.secret, rnd.masked, rnd.unmasked) == ("public", 0, 0, 0)


def test_census_counts_a_looped_round_once_per_round():
    def looped(x, r):
        for i in range(3):
            yield (x ^ r) + i

    rounds = _census(looped)
    assert [rnd.kind for rnd in rounds] == ["masked"] * 3
    assert [rnd.index for rnd in rounds] == [0, 1, 2]

    def one_raw(x, r):
        yield x ^ r
        yield x
        yield r

    assert [rnd.kind for rnd in _census(one_raw)] == ["masked", "unmasked", "masked"]


def test_census_classes_ring_values_whole():
    """An int64 payload goes on the wire as low then high words; the census
    classes each ring value as one element, in the payload's own dtype."""
    (rnd,) = _census(lambda x, r: (yield x - r), dtype=torch.int64)
    assert (rnd.kind, rnd.elements, rnd.bytes) == ("masked", 128, 64 * 8)
    (rnd,) = _census(lambda x, r: (yield torch.stack([x - r, x], dim=1)),
                     dtype=torch.int64)
    assert (rnd.kind, rnd.elements, rnd.unmasked) == ("unmasked", 256, 128)


def test_census_refuses_runs_of_another_round_structure():
    fresh = _words(3)

    def run(comm, x, r):
        def gen():
            yield x ^ r
            if x is fresh:
                yield x ^ r
        return gmw.run_streams(comm, [gen()])

    with pytest.raises(census.CensusError, match="structure"):
        census.leakage_census(run, _words(1), _words(2), fresh,
                              lambda i: _words(10 + i))


def _relu_census(k=21, m=13, n=64, same_input=False):
    """The census of one real ``gmw.relu`` (the dense adder); with
    ``same_input`` run B gets A's shares."""
    x_f = torch.linspace(-3.0, 3.0, n)
    x_fresh_f = torch.linspace(2.5, -2.5, n)

    def shares_of(seed, v):
        return shares.share(prng.PRNGKey(seed, "cpu"), fixed.encode(v))

    def masks(i):
        return (beaver.gen_relu_triples(prng.PRNGKey(20 + i, "cpu"), n, k - m),
                prng.PRNGKey(30 + i, "cpu"))

    def run(comm, x, pair):
        tri, key = pair
        return gmw.relu(key, x, tri, comm, k=k, m=m)

    x = shares_of(1, x_f)
    x_fresh = x if same_input else shares_of(2, x_fresh_f)
    rounds = census.leakage_census(run, x, masks(0), x_fresh, masks)
    return census.census_summary(rounds, schedule.simulate([(n, k - m, (n, k, m))])), \
        rounds


def test_census_of_the_real_relu_and_an_injected_raw_share(monkeypatch):
    summary, rounds = _relu_census()
    assert summary["unmasked_collectives"] == 0 and summary["cross_check_ok"]
    assert summary["collectives"] == gmw.n_rounds(8) == len(rounds)
    assert summary["secret_elements"] > 0 and summary["first_secret_round"] == 1

    def leaky_mul_rounds(x, y, triple, comm):
        e = x - triple.a
        f = y - triple.b
        other = yield torch.stack([x, f], dim=1)     # the raw share, not e
        e_open = e + other[:, 0]
        f_open = f + other[:, 1]
        z = triple.c + (e_open * triple.b + f_open * triple.a)
        return torch.where(comm.party_is(0, z), z + e_open * f_open, z)

    monkeypatch.setattr(gmw, "_beaver_mul_rounds", leaky_mul_rounds)
    summary, rounds = _relu_census()
    assert summary["cross_check_ok"]
    assert summary["unmasked_collectives"] >= 1
    assert rounds[-1].kind == "unmasked"       # the final x * DReLU(x) open


def test_census_refuses_a_run_b_that_moves_nothing():
    """A census whose run B got the same input shares (or a call that
    ignores its input) tests nothing: no element moves with the input, so
    no element could be unmasked, and the cross-check refuses it."""
    summary, rounds = _relu_census(same_input=True)
    assert summary["secret_elements"] == 0 and summary["unmasked_collectives"] == 0
    assert summary["first_secret_round"] is None
    assert summary["collectives"] == summary["sched_rounds"]
    assert summary["bytes"] == summary["sched_bytes"]
    assert not summary["cross_check_ok"]


# ---------------------------------------------------------------------------
# the canonical census and the CLI
# ---------------------------------------------------------------------------

def test_canonical_census_and_cli_default_to_the_card(monkeypatch, capsys):
    """The port's device rule: with no device the census runs on the card,
    so on a machine without one it raises, and the CLI's ``--check`` fails
    on its census (``--device cpu`` asks for the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        census.canonical_resnet_census()
    clean = str(ROOT / "src" / "repro_torch" / "device.py")
    assert hbcheck.main([clean, "--check", "--no-locks", "--no-ruff"]) == 1
    assert "census: FAILED (RuntimeError" in capsys.readouterr().out


def test_canonical_serve_step_census_zero_unmasked():
    """Acceptance on the CPU: the reference's fixture (RESNET_SMOKE, input
    (2, 3, 8, 8), HBLayer(21, 13) on every group but the last at (13, 13))
    through ``serve_step``: zero unmasked rounds, and exactly the
    schedule's rounds and bytes."""
    s = census.canonical_resnet_census("cpu")
    assert s["unmasked_collectives"] == 0, s
    assert s["cross_check_ok"] and s["secret_elements"] > 0, s
    # round 0 is the first ReLU's A2B masks; the input moves from round 1
    assert s["plans"]["reduced"]["first_secret_round"] == 1, s
    assert s["collectives"] == s["sched_rounds"] > 0, s
    assert s["bytes"] == s["sched_bytes"], s
    assert s["masked_collectives"] + s["public_collectives"] == s["collectives"], s
    assert list(s["plans"]) == ["reduced"]


_CLI = r"""
import json, runpy, sys
sys.argv = ["hbcheck", "--check", "--json", "--device", "cpu"]
try:
    runpy.run_module("repro_torch.analysis.hbcheck", run_name="__main__")
except SystemExit as e:
    rc = e.code
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
print("CLI_RC", rc, json.dumps(leaked))
"""


def test_hbcheck_cli_check_passes_on_the_cpu():
    """``python -m repro_torch.analysis.hbcheck --check --device cpu``: lint,
    locks and the census pass with the empty port baseline, and the run
    never imports jax or the reference."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _CLI], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-4000:])
    report = json.loads(out.stdout[:out.stdout.rindex("CLI_RC")])
    tail = out.stdout[out.stdout.rindex("CLI_RC"):].split(maxsplit=2)
    assert tail[1] == "0" and json.loads(tail[2]) == [], tail
    assert report["ok"] and report["findings"] == []
    assert report["census"]["unmasked_collectives"] == 0
    assert report["census"]["cross_check_ok"]


def test_hbcheck_update_baseline_writes_only_the_port_baseline(tmp_path, capsys,
                                                               monkeypatch):
    monkeypatch.chdir(ROOT)
    bad = tmp_path / "bad.py"
    bad.write_text("def f():\n    return 1\n")
    port_like = tmp_path / "src" / "repro_torch" / "core" / "leak.py"
    port_like.parent.mkdir(parents=True)
    port_like.write_text("def f(comm, p):\n    return comm.swap(p)\n")
    bl = tmp_path / "baseline.json"
    assert hbcheck.main([str(port_like), "--baseline", str(bl),
                         "--update-baseline", "--no-locks"]) == 0
    assert len(json.loads(bl.read_text())) == 1
    # the finding is grandfathered now; without the baseline --check fails
    argv = [str(port_like), "--check", "--no-census", "--no-locks", "--no-ruff"]
    assert hbcheck.main(argv + ["--baseline", str(bl)]) == 0
    assert hbcheck.main(argv + ["--baseline", str(tmp_path / "none.json")]) == 1
    assert "R001" in capsys.readouterr().out
    assert hbcheck.main([str(bad), "--update-baseline", "--baseline",
                         "tools/hbcheck_baseline.json"]) == 2


# ---------------------------------------------------------------------------
# Plan.validate pre-flight
# ---------------------------------------------------------------------------

def _valid_plan():
    hb = HBConfig((HBLayer(k=21, m=13),), (8,))
    return Plan(calls=(ReluCall(8, 0, (2, 4)),), hb=hb,
                input_shape=(2, 4), name="fixture")


def test_plan_validate_accepts_valid_and_roundtrips(tmp_path):
    plan = _valid_plan()
    assert plan.validate() is plan
    p = tmp_path / "plan.json"
    plan.save(p)
    assert Plan.load(p) == plan


def test_plan_validate_rejects_bad_group_reference():
    plan = _valid_plan()
    bad = Plan(calls=(ReluCall(8, 1, (2, 4)),), hb=plan.hb)
    with pytest.raises(errors.PlanInvalid, match="group 1"):
        bad.validate()


def test_plan_validate_rejects_element_shape_mismatch():
    plan = _valid_plan()
    bad = Plan(calls=(ReluCall(7, 0, (2, 4)),), hb=plan.hb)
    with pytest.raises(errors.PlanInvalid, match="claims 7"):
        bad.validate()


def test_plan_validate_rejects_group_accounting_drift():
    hb = HBConfig((HBLayer(k=21, m=13),), (9,))
    bad = Plan(calls=(ReluCall(8, 0, (2, 4)),), hb=hb)
    with pytest.raises(errors.PlanInvalid, match="group_elements"):
        bad.validate()


def test_plan_load_wraps_malformed_json(tmp_path):
    plan = _valid_plan()
    d = plan.to_json()
    d["hb"]["layers"][0]["k"] = 99           # outside the ring
    p = tmp_path / "bad_k.json"
    p.write_text(json.dumps(d))
    with pytest.raises(errors.PlanInvalid):
        Plan.load(p)
    d = plan.to_json()
    del d["calls"]
    p2 = tmp_path / "missing.json"
    p2.write_text(json.dumps(d))
    with pytest.raises(errors.PlanInvalid):
        Plan.load(p2)
    # PlanInvalid is a ValueError, so legacy call sites keep working
    assert issubclass(errors.PlanInvalid, ValueError)


def test_plan_validate_is_trivial_for_trace_free_plans():
    Plan.from_hb(HBConfig((HBLayer(k=21, m=13),), (8,))).validate()
