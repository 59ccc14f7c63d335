"""The check that decides ``correct``, driven on the CPU at a small size
with the timed path broken underneath: each fault the cells can have must
read not correct, and the sound path correct.  The look for a card is
skipped: ``harness.run`` is called directly on the CPU."""
import pytest
import torch

from hbbench.lib import cell as cell_lib, harness
from repro_torch.api.compile import PrivateModel
from repro_torch.core import comm as comm_lib

SEED = 2 ** 31 + 7919


def small_resnet():
    cell = cell_lib.find("r18-exact-c8")
    cell.cfg.update(widths=[8, 16], stage_blocks=[1, 1], in_hw=16)
    cell.plan = {"groups": [{"k": 64, "m": 0}] * 3}
    cell.workload = dict(cell.workload, clients=4)
    return cell


def small_lm():
    cell = cell_lib.find("lm512-sitewise-c1")
    cell.cfg.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
                    intermediate_size=128, num_hidden_layers=1, vocab_size=256,
                    seq_len=16)
    return cell


def _run(cell):
    result, _ = harness.run(cell, SEED, 0.5, False, "cpu")
    return result


def _exchange_left_out(monkeypatch):
    monkeypatch.setattr(comm_lib.SimComm, "swap", lambda self, x: x)


def _half_the_clients_left_out(monkeypatch):
    orig = PrivateModel.__call__

    def call(self, xs, *, key=None):
        outs = orig(self, xs, key=key)
        half = max(1, len(outs) // 2)
        return outs[:half] + [outs[0]] * (len(outs) - half)     # answers only half

    monkeypatch.setattr(PrivateModel, "__call__", call)


def _answer_altered(monkeypatch):
    orig = PrivateModel.__call__

    def call(self, xs, *, key=None):
        outs = orig(self, xs, key=key)
        outs[-1].data.view(-1)[0] += 1 << 16          # one logit off by 1.0
        return outs

    monkeypatch.setattr(PrivateModel, "__call__", call)


FAULTS = {"resnet": (_exchange_left_out, _half_the_clients_left_out, _answer_altered),
          "lm": (_exchange_left_out, _answer_altered)}
CELLS = {"resnet": small_resnet, "lm": small_lm}


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_sound_path_is_correct(kind):
    result = _run(CELLS[kind]())
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("kind,fault", [(k, f) for k, fs in FAULTS.items() for f in fs],
                         ids=lambda x: getattr(x, "__name__", x).strip("_"))
def test_fault_reads_not_correct(kind, fault, monkeypatch):
    torch.manual_seed(0)
    fault(monkeypatch)
    result = _run(CELLS[kind]())
    assert not result["correct"], result["checks"]
