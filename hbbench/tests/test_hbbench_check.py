"""The numbers that decide ``correct``, on made-up logits: a request's
error on the run's logit scale, the share of wrong requests, the sample of
calls the check keeps."""
import math

import pytest
import torch

from hbbench.lib import cell as cell_lib, harness


def _run(got, want):
    return harness.request_errors(got, ((i, w) for i, w in sorted(want.items())))


def test_errors_are_gaps_over_the_runs_logit_rms():
    want = {0: torch.tensor([[3.0, -4.0], [0.0, 0.0]]), 1: torch.tensor([[0.0, 5.0]])}
    got = {0: want[0] + torch.tensor([[0.5, 0.0], [0.0, -1.0]]), 1: want[1].clone()}
    req = _run(got, want)
    rms = math.sqrt((9 + 16 + 25) / 6)
    assert req["errors"] == pytest.approx([0.5 / rms, 1.0 / rms, 0.0])
    assert req["nonfinite"] == 0


def test_a_wrapped_request_is_one_wrong_answer():
    want = {i: torch.randn(8, 10, generator=torch.Generator().manual_seed(i))
            for i in range(4)}
    got = {i: w + 1e-5 for i, w in want.items()}
    got[2][5, 3] += 2.0 ** 32            # a truncation wrap in one request
    errors = _run(got, want)["errors"]
    assert harness.judge(errors, 2e-3) == 1 / 32
    summary = harness.error_summary(errors, 2e-3)
    assert summary["requests"] == 32 and summary["over_limit"] == 1
    assert summary["p50"] < 2e-3 < summary["max"]


def test_a_nonfinite_logit_is_wrong_and_counted():
    want = {0: torch.zeros(2, 3) + 1.0}
    got = {0: torch.tensor([[1.0, float("nan"), 1.0], [1.0, 1.0, 1.0]])}
    req = _run(got, want)
    assert req["nonfinite"] == 1
    assert harness.judge(req["errors"], 1e-3) == 0.5


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 12345])
def test_the_sample_of_calls_is_drawn_from_the_seed(seed):
    cell = cell_lib.find("lm512-sitewise-c1")
    check = cell.workload["check"]
    keep = harness.keep_for_check(cell, seed)
    chosen = [i for i in range(check["sample_from"] + 8) if keep(i)]
    assert len(chosen) == check["sample_calls"]
    assert max(chosen) < check["sample_from"]
    assert chosen == [i for i in range(64) if harness.keep_for_check(cell, seed)(i)]


def test_resnet_cells_keep_every_call():
    for name in ("r18-range-c8", "r18-exact-c8"):
        keep = harness.keep_for_check(cell_lib.find(name), 7)
        assert all(keep(i) for i in range(1000))
