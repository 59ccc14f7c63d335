#!/usr/bin/env python3
"""Time unpack and pack at every shape that the main path's triple merges
and sign planes give them, for one checkout's kernels, and sum them per
call, for both merge routes.

    python3 tools/bitpack_bench.py [--tree DIR]

``--tree DIR`` uses the ``repro_torch`` package of the checkout at DIR
(default: this one), e.g. ``git archive <commit>`` unpacked into the
gitignored ``build/``, so that two trees' kernels run in turns in one call
on one card (parent, change, change, parent), each in its own process:

    for t in build/parent . . build/parent; do
        python3 tools/bitpack_bench.py --tree $t; done

For each of ``chip_smoke.py``'s four plans (full-width ResNet-18, 4
requests as sibling streams) and each ReLU, two routes:
- ``bit``: the 4 streams' triples merge at the bit level: every binary
  member of every stream is unpacked (a, b and c; one plane per row) and
  the concatenation packed, then the sign plane is unpacked;
- ``word``: the merge concatenates the words (no kernel), and only the
  sign plane is unpacked.
The shapes come from the plans' widths and the triples' layout
(``beaver.gen_relu_triples``); each distinct shape is timed once, as
``chip_smoke.py`` times a kernel (cold from device memory, hot from L2,
eager), and the sums are launches x time.  Outputs are not checked here:
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold both kernels
against their plain versions.  The last line of the output is one JSON
object with every shape's record and the sums.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (after the path: it sits at the repo root)

P = 2
KEYS = ("ms", "hot_ms", "eager_call_ms", "bound_ms")


def member_rows(w: int, cone: bool) -> list:
    """Rows (planes over the parties) of each packed binary member of one
    stream's ReluTriples at ring width w: bin_init, then the dense level
    stack or each cone level."""
    from repro_torch.core.schedule import cone_sets, n_levels

    if cone and w > 1:
        init_pos, level_sets = cone_sets(w)
        return [P * len(init_pos)] + [P * 2 * max(len(pos), 1) for pos in level_sets]
    return [P * w, max(n_levels(w), 1) * P * 2 * w]


def launches(plan: str, route: str) -> Counter:
    """(kernel, rows, elements) -> launches per main-path call."""
    out = Counter()
    for (n, relus), w in zip(chip_smoke.RELU_GROUPS, chip_smoke.PLAN_WIDTHS[plan]):
        if not w:
            continue
        out[("unpack", P, chip_smoke.STREAMS * n)] += relus
        if route == "bit":
            for rows in member_rows(w, plan.endswith("cone")):
                out[("unpack", rows, n)] += 3 * chip_smoke.STREAMS * relus
                out[("pack", rows, chip_smoke.STREAMS * n)] += 3 * relus
    return out


def time_shape(kernel: str, rows: int, n: int, flush, gen) -> dict:
    from repro_torch.kernels import ops

    n_words = (n + 31) // 32
    if kernel == "unpack":
        x = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, 1, n_words), generator=gen,
                          dtype=torch.int32, device="cuda")
        fn = lambda: ops.unpack(x, n)   # noqa: E731
    else:
        x = torch.randint(0, 2, (rows, n), generator=gen, dtype=torch.int32,
                          device="cuda")
        fn = lambda: ops.pack(x, 1)     # noqa: E731
    ms, hot_ms = chip_smoke.device_ms(fn, flush)
    bytes_moved = 4 * rows * n + 4 * rows * n_words
    return {"kernel": kernel, "rows": rows, "n": n, "ms": ms, "hot_ms": hot_ms,
            "eager_call_ms": chip_smoke.eager_ms(fn),
            "bound_ms": bytes_moved / chip_smoke.HBM_BYTES_PER_S * 1e3}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=ROOT,
                        help="checkout whose src/repro_torch is timed")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bitpack_bench: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.kernels import build

    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    print(f"build: {build.build_all():.1f} s ({build.__file__})", flush=True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda").zero_
    gen = torch.Generator(device="cuda").manual_seed(0)
    counts = {(plan, route): launches(plan, route)
              for plan in chip_smoke.PLAN_WIDTHS for route in ("bit", "word")}
    shapes = sorted(set().union(*counts.values()))
    recs = {shape: time_shape(*shape, flush, gen) for shape in shapes}
    sums = {}
    for (plan, route), count in counts.items():
        for kernel in ("unpack", "pack"):
            mine = {s: c for s, c in count.items() if s[0] == kernel}
            total = {key: sum(c * recs[s][key] for s, c in mine.items()) for key in KEYS}
            total["launches"] = sum(mine.values())
            sums[f"{plan} {route} {kernel}"] = total
            print(f"{plan:12s} {route} route, {kernel:6s}: {total['launches']:5d} "
                  f"launches, {total['ms']:.4f} ms from DRAM, {total['hot_ms']:.4f} "
                  f"ms from L2, {total['eager_call_ms']:.4f} ms eager; bound "
                  f"{total['bound_ms']:.4f} ms", flush=True)
    print(json.dumps({"tree": args.tree, "nvidia_smi": smi,
                      "shapes": list(recs.values()), "per_call": sums}))


if __name__ == "__main__":
    main()
