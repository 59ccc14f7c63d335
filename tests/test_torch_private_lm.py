"""The private LM at a user's length, and ``tools/private_lm.py`` (the
port's twin of ``examples/private_lm.py``), against the reference:

- (a) the long LM path's plans, full-width Qwen1.5-0.5B at 1 x 512 tokens,
  depths 1 and 2, both budgets, traced from abstract params (the
  reference's ``jax.eval_shape``, the port's ``meta`` tensors): JSON and
  ``digest()`` equal, ``schedule(streams=1)`` rounds and bytes equal to
  each other and to ``chip_smoke.LM_SCHEDULE`` where its ``lm_long`` phase
  runs the plan;
- (b) ``tools/private_lm.py --device cpu`` at its defaults (as a command)
  and with ``--budget 8of64`` (in this process) finishes, and the rounds
  and bytes it prints equal the reference's ``lm.trace(...).schedule()``
  for the same arguments;
- (c) without a card, ``tools/private_lm.py`` with no ``--device`` raises.

No forward at 512 tokens runs here: ``tests/test_torch_lm_long.py`` holds
one block bit for bit at S = 128.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.core.hummingbird import HBConfig as JHBConfig, HBLayer as JHBLayer
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.core.hummingbird import HBConfig, HBLayer
from repro_torch.launch import specs
from repro_torch.models import lm as tlm
from repro_torch.train import optimizer as opt_lib

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402
import private_lm  # noqa: E402

torch.set_num_threads(1)

ARCH, SEQ = "qwen1.5-0.5b", 512
# chip_smoke's lm_long phase: its plan name for each (depth, budget) it runs
CHIP_PLANS = {(layers, name.rsplit("-", 1)[1]): name
              for name, layers in chip_smoke.LM_LONG_LAYERS.items()}


def _kms(n_groups: int, budget: str):
    """The 8of64 budget's per-site (k, m): (22, 0) on the score groups,
    (22, 6) on the PWL groups; None for the exact plan."""
    if budget == "exact":
        return None
    return [(22, 0) if g % 2 == 0 else (22, 6) for g in range(n_groups)]


def _ref_plan(arch: str, layers: int, seq: int, budget: str):
    cfg = dataclasses.replace(jconfigs.get(arch), n_layers=layers)
    params = jax.eval_shape(functools.partial(jlm.init, cfg=cfg),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    plan = jlm.trace(params, cfg, 1, seq)
    kms = _kms(plan.hb.n_groups, budget)
    return plan if kms is None else plan.with_hb(JHBConfig(
        tuple(JHBLayer(k=k, m=m) for k, m in kms), plan.hb.group_elements))


def _port_plan(arch: str, layers: int, seq: int, budget: str):
    cfg = dataclasses.replace(tconfigs.get(arch), n_layers=layers, dtype="float32")
    params = opt_lib.tree_map(lambda leaf: torch.empty(leaf.shape, dtype=torch.float32,
                                                       device="meta"),
                              specs.param_shapes(cfg, "serve"))
    plan = tlm.trace(params, cfg, 1, seq)
    kms = _kms(plan.n_groups, budget)
    return plan if kms is None else plan.with_hb(HBConfig(
        tuple(HBLayer(k=k, m=m) for k, m in kms), plan.group_elements))


@pytest.mark.parametrize("budget", ["exact", "reduced"])
@pytest.mark.parametrize("layers", [1, 2])
def test_long_plan_equals_the_reference_and_chip_smoke(layers, budget):
    port, ref = _port_plan(ARCH, layers, SEQ, budget), _ref_plan(ARCH, layers, SEQ, budget)
    assert port.to_json() == ref.to_json()
    assert port.digest() == ref.digest()
    ps, rs = port.schedule(streams=1), ref.schedule(streams=1)
    assert (ps.n_rounds, ps.bytes_tx) == (rs.n_rounds, rs.bytes_tx)
    assert len(port.calls) == 2 * layers and len(port.opens) == 3 * layers
    assert port.calls[0].shape == (1, 16, SEQ, SEQ)            # S^2 attention scores
    name = CHIP_PLANS.get((layers, budget))
    if name is not None:
        assert chip_smoke.LM_SCHEDULE[name] == (ps.n_rounds, ps.bytes_tx)


def _printed(out: str) -> dict:
    """The tool's last output line (JSON) and its schedule line's figures."""
    last = json.loads(out.strip().splitlines()[-1])
    line = next(x for x in out.splitlines() if "fused rounds" in x)
    rounds = int(line.split("->")[1].split("fused rounds")[0])
    nbytes = int(line.split("fused rounds,")[1].split("B/party")[0])
    assert (rounds, nbytes) == (last["rounds"], last["bytes_tx"])
    assert (last["measured_rounds"], last["measured_bytes"]) == (rounds, nbytes)
    return last


def test_private_lm_tool_at_its_defaults_equals_the_reference():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "private_lm.py"),
                           "--device", "cpu"], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = _printed(proc.stdout)
    want = _ref_plan("qwen1.5-0.5b-smoke", 1, 8, "exact").schedule()
    assert (got["rounds"], got["bytes_tx"]) == (want.n_rounds, want.bytes_tx)
    assert got["argmax_equal"] and got["served_requests"] == 2
    assert got["served_rounds"] == got["rounds"] and got["max_abs_err"] < 1e-2


def test_private_lm_tool_8of64_equals_the_reference(capsys):
    got = private_lm.main(["--device", "cpu", "--budget", "8of64"])
    assert _printed(capsys.readouterr().out) == got
    want = _ref_plan("qwen1.5-0.5b-smoke", 1, 8, "reduced").schedule()
    assert (got["rounds"], got["bytes_tx"]) == (want.n_rounds, want.bytes_tx)
    assert got["served_rounds"] == got["rounds"]


def test_private_lm_tool_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        private_lm.main([])
