"""The frozen work counts (``hbbench/work``) against ``chip_smoke.py``'s
bound functions, and the cells' shape enumerations against the plans the
program traces, at the shapes each cell's plan launches."""

import dataclasses

import pytest
import torch

import chip_smoke
from hbbench.lib import cell as cell_lib
from hbbench.work import adder, linear, peaks

CELLS = ("r18-range-c8", "lm512-sitewise-c1", "r18-exact-c8")


def test_peaks_are_chip_smokes():
    assert peaks.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert peaks.INT8_OPS_PER_S == chip_smoke.INT8_OPS_PER_S


def _least(kind, shape):
    ops, nbytes = (linear.public_work(*shape) if kind == "public"
                   else linear.secret_work(*shape))
    return nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.INT8_OPS_PER_S


@pytest.mark.parametrize("name", CELLS)
def test_linear_work_is_chip_smokes_bound(name):
    cell = cell_lib.find(name)
    for kind, shape, _ in cell.model.linear_shapes(cell.cfg, cell.workload["clients"]):
        bound = (chip_smoke.ring_matmul_bound_s(*shape) if kind == "public"
                 else chip_smoke.ring_matmul_ss_bound_s(*shape))
        assert _least(kind, shape) == pytest.approx(bound, rel=1e-12)


def test_resnet_shapes_are_chip_smokes():
    cell = cell_lib.find("r18-exact-c8")
    got = {s: c for _, s, c in cell.model.linear_shapes(cell.cfg, chip_smoke.STREAMS)}
    assert got == {(m, k, n): c for m, k, n, c in chip_smoke.RING_MATMUL_SHAPES}


def _lm_setup(cell):
    """chip_smoke's LM setup tuple on the meta device."""
    weights = cell.model.make_weights(cell.cfg, 0, "meta")
    params, port_cfg, plan = cell.model.program(cell.cfg, weights, cell.plan, "meta")
    hs = [torch.empty(1, cell.cfg["seq_len"], cell.cfg["hidden_size"], device="meta")]
    return plan, (port_cfg, params, None, hs, None)


def test_lm_shapes_are_chip_smokes():
    cell = cell_lib.find("lm512-sitewise-c1")
    plan, setup = _lm_setup(cell)
    want = chip_smoke.lm_shape_launches(plan, setup)
    got = {"public": {}, "secret": {}}
    for kind, shape, count in cell.model.linear_shapes(cell.cfg, 1):
        got[kind][shape] = got[kind].get(shape, 0) + count
    assert got["public"] == want["ring_matmul"]
    assert got["secret"] == want["ring_matmul_ss"]


def _traced_plan(cell):
    if cell.config_name.startswith("qwen"):
        return _lm_setup(cell)[0]
    weights = cell.model.make_weights(cell.cfg, 0, "cpu")
    return cell.model.program(cell.cfg, weights, cell.plan, "cpu")[2]


@pytest.mark.parametrize("name", CELLS)
def test_relu_calls_are_the_traced_plans(name):
    cell = cell_lib.find(name)
    clients = cell.workload["clients"]
    want = [(w, clients * n) for n, w in _traced_plan(cell).triple_specs()]
    assert cell.model.relu_calls(cell.cfg, cell.plan, clients) == want


@pytest.mark.parametrize("w", (2, 3, 8, 13, 16, 22, 23, 24, 25, 26, 27, 64))
@pytest.mark.parametrize("n", (8192 * 8, 65536 * 8, 47579136, 8209))
def test_adder_bytes_are_chip_smokes_cone_bytes(w, n):
    words = (n + 31) // 32
    rounds = 1 + len(adder.cone_levels(w))
    want = sum(chip_smoke.cone_step_bytes(w, r, words) for r in range(rounds))
    assert adder.adder_bytes(w, n) == want


@pytest.mark.parametrize("name", CELLS)
def test_adder_work_is_the_same_for_dense_and_cone_plans(name):
    """The port's plan in either adder form launches the same widths and
    element counts, so the adder's least bytes are one count for both."""
    cell = cell_lib.find(name)
    clients = cell.workload["clients"]
    plan = _traced_plan(cell)
    work = [adder.call_bytes([(w, clients * n) for n, w in p.triple_specs()])
            for p in (dataclasses.replace(plan, cone=False),
                      dataclasses.replace(plan, cone=True))]
    assert work[0] == work[1] > 0
