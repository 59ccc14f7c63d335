"""On the card, at each cell's own size: the control (the program with its
inputs shared at 12 fractional bits in place of 16) reads not correct on
three seeds, and the program correct on the same seeds."""
import pytest

from hbbench.lib import cell as cell_lib

SEEDS = (2 ** 31 + 7919 * 21, 2 ** 31 + 7919 * 22, 2 ** 31 + 7919 * 23)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in cell_lib.manifest()["workloads"]])
def test_control_fails_and_program_passes(card, name):
    from hbbench.tools.readings import readings

    for seed in SEEDS:
        r = readings(name, seed, 2.0, card)
        assert r["correct"], r
        assert not r["control_correct"], r
