"""r18-range's k per group holds the activation range of the traffic's
images (apart from the calibration images) under the seeds of the runs on
the card and a spread of others, on the CPU at full width: Theorem 1's
condition |x| < 2^(k-1) in fixed point, so the range plan computes the
exact sign."""
import importlib.util
import pathlib

import pytest
import torch

from hbbench.lib import cell as cell_lib

ROOT = pathlib.Path(__file__).resolve().parents[2]
_spec = importlib.util.spec_from_file_location(
    "hbbench_calibrate_range", ROOT / "hbbench" / "tools" / "calibrate_range.py")
calibrate = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(calibrate)

CALLS = 4          # the first calls of each seed's traffic: 32 images


@pytest.mark.parametrize("seed", calibrate.CHECK_SEEDS)
def test_range_plan_holds_on_the_traffic(seed):
    cell = cell_lib.find("r18-range-c8")
    images = torch.cat([torch.cat(cell.model.make_inputs(cell.cfg, seed, i, 8, "cpu"))
                        for i in range(CALLS)])
    maxima = calibrate.group_maxima(cell.cfg, seed, images)
    for g, (m, layer) in enumerate(zip(maxima, cell.plan["groups"])):
        assert layer["m"] == 0
        assert m * 2 ** calibrate.FRAC_BITS < 2 ** (layer["k"] - 1), (g, m, layer)
