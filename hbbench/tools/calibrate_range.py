"""Work out the ``r18-range`` plan: HummingBird's error-free setting, every
group at m = 0 and k wide enough for its activations (Theorem 1).

    python hbbench/tools/calibrate_range.py [--write]

For each ReLU group, the largest |pre-activation| over the calibration
images (a stream kept apart from every run's traffic) and over the weights
of ``SEEDS``, in fixed point (x 2^16), gives k = ceil(log2(max)) + 1 +
``MARGIN_BITS``.  Runs on the CPU at full width.  ``--write`` writes the
plan file.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT)]

import torch  # noqa: E402

from hbbench.lib import cell as cell_lib  # noqa: E402

#: the weights the plan is calibrated over
SEEDS = tuple(range(16)) + tuple(2 ** 31 + 7919 * i for i in range(1, 25))
#: seeds the plan is held to (tests/test_hbbench_range.py): the seeds of
#: the runs on the card that set the limits and bounds, and 128 spread
#: over [0, 2^32), standing for the fresh seeds of later checks
CHECK_SEEDS = (tuple(2 ** 31 + 7919 * i for i in range(1, 97))
               + tuple((i * 0x9E3779B1) % 2 ** 32 for i in range(1, 129)))
MARGIN_BITS = 2
FRAC_BITS = 16
IMAGES = 64
CONFIG = "resnet18-cifar10"


def group_maxima(cfg, seed: int, images: torch.Tensor) -> list:
    """max |pre-ReLU| per group of ``images`` under the seed's weights."""
    mod, ref = cell_lib.config_module(CONFIG), cell_lib.reference_module(CONFIG)
    out = [0.0] * (1 + len(cfg["stage_blocks"]))

    def relu(v, g):
        out[g] = max(out[g], float(v.abs().max()))
        return torch.relu(v)

    with torch.no_grad():
        ref.forward(cfg, mod.make_weights(cfg, seed, "cpu"), images, relu=relu)
    return out


def safe_k(max_abs: float, margin_bits: int = MARGIN_BITS) -> int:
    need = max(max_abs * 2 ** FRAC_BITS, 1.0)
    return min(64, max(2, math.ceil(math.log2(need)) + 1 + margin_bits))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args()
    cfg = cell_lib.find("r18-range-c8").cfg
    mod = cell_lib.config_module(CONFIG)
    images = mod.calibration_images(cfg, IMAGES, "cpu")
    maxima = [0.0] * (1 + len(cfg["stage_blocks"]))
    for seed in SEEDS:
        maxima = [max(a, b) for a, b in zip(maxima, group_maxima(cfg, seed, images))]
    ks = [safe_k(m) for m in maxima]
    print("max |pre-ReLU| per group:", maxima)
    print("k per group:", ks)
    if args.write:
        plan = {"why": "HummingBird's error-free setting: m = 0 and k from the "
                       "activations' range (tools/calibrate_range.py)",
                "groups": [{"k": k, "m": 0} for k in ks],
                "calibration": {"max_abs": maxima, "margin_bits": MARGIN_BITS,
                                "frac_bits": FRAC_BITS, "images": IMAGES,
                                "seeds": "tools/calibrate_range.py SEEDS"}}
        path = ROOT / "hbbench" / "plans" / "r18-range.json"
        path.write_text(json.dumps(plan, indent=2) + "\n")


if __name__ == "__main__":
    main()
