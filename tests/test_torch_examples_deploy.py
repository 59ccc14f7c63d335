"""The port's twins of the two deployment examples,
``tools/private_inference.py`` and ``tools/two_party_serving.py``, against
the reference package:

- private_inference: (a) a fixed-(k, m) plan with the cone adder, saved by
  ``repro.api.Plan.save``, goes in through ``--plan-in`` with
  ``--requests 4``: the adopted plan's digest, and the printed reduction
  factors, fused rounds, MB/party and LAN and WAN estimates, equal the
  reference's for that plan; (b) at its search defaults with
  ``--plan-out`` the twin writes a plan that ``repro.api.Plan.load`` reads
  with the same digest, within ``--budget``, whose printed figures equal
  the reference's pricing of it; (c) a ``--plan-in`` with another group
  count exits with the reference script's message.  Accuracies are not
  compared: the weights and the float training differ;
- two_party_serving: ``--make-job`` of the twin and the reference's
  ``make_job`` write byte-equal ``plan.json`` and ``job.json`` contents,
  bit-equal pool leaves, and input shares that decode within 1e-4 (their
  floats come from ``normal()``); one run at its defaults with ``--device
  cpu`` as a command answers three requests with measured rounds equal to
  the reference plan's schedule and exits 0; a job that the party
  processes cannot load ends the run non-zero, naming the returncode.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import RESNET_SMOKE as JSMOKE
from repro.core import costmodel as jcost
from repro.core.hummingbird import HBConfig as JHBConfig, HBLayer as JHBLayer
from repro.models import resnet as jres
from repro_torch.core import fixed, ring, shares

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import private_inference  # noqa: E402
import two_party_serving  # noqa: E402

FIXED = ((21, 13), (22, 14), (13, 13))
RUN_WAIT_S = 600


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def jafn(p, v, relu_fn=None):
    return jres.apply(p, v, JSMOKE, relu_fn=relu_fn)


def jplan(requests: int):
    """The reference's trace of the private_inference model (abstract
    params: tracing needs no values)."""
    params = jax.eval_shape(lambda k: jres.init(k, JSMOKE), jax.random.PRNGKey(0))
    return japi.trace_plan(jafn, params, (requests, 3, JSMOKE.in_hw, JSMOKE.in_hw),
                           name=JSMOKE.name)


# ---------------------------------------------------------------------------
# private_inference
# ---------------------------------------------------------------------------

def check_report(got: dict, out: str, plan) -> None:
    """The twin's [4/4] figures against the reference's pricing of ``plan``,
    printed as the reference script prints them."""
    r = jcost.reduction_factors(plan.hb)
    sched, cost = plan.schedule(), plan.cost()
    lan, wan = plan.estimate(network=japi.LAN), plan.estimate(network=japi.WAN)
    lines = out.splitlines()
    assert (f"      comm reduction vs CrypTen-64: {r['bytes_reduction']:.2f}x "
            f"bytes, {r['rounds_reduction']:.2f}x rounds, "
            f"{r['bits_discarded_frac']*100:.1f}% of DReLU bits discarded") in lines
    assert (f"      plan schedule: {sched.n_rounds} fused rounds, "
            f"{cost.bytes_tx / 1e6:.1f} MB/party, "
            f"LAN {lan*1e3:.1f} ms, WAN {wan:.2f} s") in lines
    assert {k: got[k] for k in r} == r
    assert (got["rounds"], got["bytes_tx"], got["lan_s"], got["wan_s"]) == \
        (sched.n_rounds, cost.bytes_tx, lan, wan)
    assert got["digest"] == plan.digest()


def test_private_inference_plan_in_prices_as_the_reference(tmp_path, capsys):
    saved = jplan(4)
    saved = dataclasses.replace(saved.with_hb(JHBConfig(
        tuple(JHBLayer(k=k, m=m) for k, m in FIXED), saved.hb.group_elements)), cone=True)
    path = tmp_path / "plan.json"
    saved.save(path)
    got = private_inference.main(["--device", "cpu", "--plan-in", str(path),
                                  "--requests", "4"])
    out = capsys.readouterr().out
    assert last_json(out) == got
    assert (got["kms"], got["cone"], got["search"]) == ([list(km) for km in FIXED], True, None)
    assert (f"[2/4] reusing saved plan {path}: {list(FIXED)} "
            f"({saved.hb.budget_fraction():.3f} of bits)") in out.splitlines()
    check_report(got, out, saved)


def test_private_inference_search_defaults_write_a_reference_plan(tmp_path, capsys):
    path = tmp_path / "searched.json"
    got = private_inference.main(["--device", "cpu", "--plan-out", str(path)])
    out = capsys.readouterr().out
    assert last_json(out) == got
    loaded = japi.Plan.load(path)
    assert loaded.digest() == got["digest"]
    assert loaded.calls == jplan(16).calls
    assert loaded.hb.budget_fraction() <= 8 / 64
    assert got["search"]["objective"] == "bytes"
    assert f"      plan saved to {path}" in out.splitlines()
    check_report(got, out, loaded)


def test_private_inference_plan_in_with_other_groups_exits(tmp_path):
    def mlp(p, v, relu_fn=None):
        return relu_fn(relu_fn(v @ p["w1"], 0) @ p["w2"], 1)

    params = {"w1": jnp.zeros((6, 5), jnp.float32), "w2": jnp.zeros((5, 4), jnp.float32)}
    other = japi.trace_plan(mlp, params, (2, 6), name="mlp")
    path = tmp_path / "other.json"
    other.save(path)
    with pytest.raises(SystemExit) as exc:
        private_inference.main(["--device", "cpu", "--plan-in", str(path),
                                "--requests", "4"])
    assert str(exc.value.code) == (
        f"--plan-in {path}: saved plan has 2 ReLU groups but this model traces 3 "
        "— it was searched for a different model/config")


# ---------------------------------------------------------------------------
# two_party_serving
# ---------------------------------------------------------------------------

def _decoded_input(job: Path) -> np.ndarray:
    rows = []
    for p in (0, 1):
        with np.load(job / f"party{p}.npz") as npz:
            rows.append(ring.from_limbs(npz["x_lo"], npz["x_hi"], "cpu"))
    return fixed.decode_np(shares.reconstruct(torch.cat(rows)))


def test_two_party_make_job_equals_the_reference(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "example_two_party_serving", ROOT / "examples" / "two_party_serving.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    ref.make_job(tmp_path / "ref")
    assert two_party_serving.main(["--device", "cpu", "--make-job",
                                   str(tmp_path / "port")]) == {"job": str(tmp_path / "port")}
    want, got = tmp_path / "ref", tmp_path / "port"
    assert (got / "plan.json").read_bytes() == (want / "plan.json").read_bytes()
    assert json.loads((got / "job.json").read_text()) == \
        json.loads((want / "job.json").read_text())
    for p in (0, 1):
        with np.load(want / f"party{p}.npz") as a, np.load(got / f"party{p}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            leaves = [k for k in a.files if k.startswith("t")]
            assert leaves
            for k in leaves:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(b[k], a[k])
    np.testing.assert_allclose(_decoded_input(got), _decoded_input(want), rtol=0, atol=1e-4)


def _run_twin(*args):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, str(ROOT / "tools" / "two_party_serving.py"),
                           "--device", "cpu", *args], capture_output=True, text=True,
                          env=env, timeout=RUN_WAIT_S)


def test_two_party_serving_twin_serves_as_the_reference_plan_predicts():
    proc = _run_twin()
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = last_json(proc.stdout)
    plan = japi.trace_plan(jafn, jax.eval_shape(lambda k: jres.init(k, JSMOKE),
                                                jax.random.PRNGKey(0)),
                           (2, 3, 8, 8), name="smoke")
    plan = plan.with_hb(JHBConfig(tuple([JHBLayer(k=21, m=13)] * (plan.n_groups - 1)
                                        + [JHBLayer(k=13, m=13)]), plan.group_elements))
    rounds = plan.schedule().n_rounds
    assert [r["tenant"] for r in got["requests"]] == ["alice", "bob", "alice"]
    for r in got["requests"]:
        assert r["measured_rounds"] == r["predicted_rounds"] == rounds
        assert np.asarray(r["y"]).shape == (2, JSMOKE.n_classes)
    assert got["transport"]["rounds"] == got["batches"] * rounds
    assert got["transport"]["retries"] == 0
    # the leader's /stats carries its kernel launches: none on the CPU
    assert set(got["leader_launches"]) >= {"ring_matmul", "pack_ring", "pack_ring_masked"}
    assert not any(got["leader_launches"].values())
    assert "frontend healthy at" in proc.stdout


def test_two_party_serving_party_that_exits_early_fails_the_run(tmp_path):
    proc = _run_twin("--job", str(tmp_path / "no-such-job"))
    assert proc.returncode != 0
    assert "exited early with returncode" in proc.stderr
