#!/usr/bin/env python3
"""Time the GMW adders' kernels at every shape the main path gives them,
sum them per call for each plan, and (``--walls``) time the online wall.

    python3 tools/gmw_bench.py [--tree DIR] [--walls [PLAN,...]] [--profile]

``--tree DIR`` uses the ``repro_torch`` package of the checkout at DIR
(default: this one), e.g. ``git archive <commit>`` unpacked into the
gitignored ``build/``, so that two trees run in turns in one call on one
card (parent, change, change, parent), each in its own process:

    for t in build/parent . . build/parent; do
        python3 tools/gmw_bench.py --tree $t; done

For each of ``chip_smoke.py``'s four plans (full-width ResNet-18, 4
requests as sibling streams, merged into one stream per ReLU) and each
ReLU of width w > 1 over W = 4 n / 32 words:
- the dense plans' adder by two routes:
  - ``level``: per level, ``ks_mask``, ``torch.stack`` of (d, e) and
    ``ks_combine`` (the route before the fused step; on a tree whose
    ``ks_mask`` returns the stacked send buffer the stack is timed on its
    own all the same);
  - ``step``: ``ks_mask`` of level 0, ``ks_step`` between two exchanges,
    ``ks_combine`` of the last level without p (the tree must have
    ``ops.ks_step``);
  both after the initial AND's ``beaver_and`` (in its opening form on
  trees that have it, as the adder runs it);
- the cone plans' adder by two routes:
  - ``cone``: the initial ``beaver_and`` over w - 1 planes, then per
    non-empty level one ``beaver_and`` and one ``ks_level`` (the route
    before the fused step; the torch.cat, XOR and stack passes between
    them are not timed);
  - ``fused``: one ``cone_step`` per round, the initial AND's and each
    non-empty level's (the tree must have ``ops.cone_step``).
Each distinct shape is timed once from device memory (L2 flushed before
each call, ``chip_smoke.device_ms``); sums are launches x ms and launches
x bound per call, per kernel, plan and route.  Outputs are not checked
here: ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold every kernel
against its plain version.

``--walls`` also times the online wall of the dense plans on the tree (or
of the plans named, e.g. ``--walls exact-cone,reduced-cone``), as
``chip_smoke.py`` does (pool made beforehand, one warm-up call, the median
of ``chip_smoke.ONLINE_CALLS`` calls, on the generator loop and, where the
tree has it, on the captured replay; rounds, bytes and exact reveals
checked, the kernel set not, so that a tree with the per-level route runs
too); ``--profile`` runs one more call of each exact plan among them under
torch.profiler (device ops and busy share).  The last line of the output
is one JSON object with every record.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
from collections import Counter

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (after the path: it sits at the repo root)

P = 2
KEYS = ("ms", "hot_ms", "bound_ms")
# bytes per (party, row, word) each form reads and writes once; for the
# dense level's kernels a row is a plane of w; for cone_step every row it
# must read or write once, counted per round by ``chip_smoke.cone_step_rows``
# (814 rows after w = 64's initial AND, 12.9 per AND row; 657 after its
# first level, 10.6 per AND row)
BYTES_PER_ROW_WORD = {"beaver_and": 24, "ks_level": 20, "ks_mask": 40,
                      "stack": 32, "ks_combine": 68, "ks_combine_g": 36,
                      "ks_step": 96, "cone_step": 4, "beaver_and_open": 32}


def launches(plan: str, route: str, opening: bool = False) -> Counter:
    """(kernel, rows, words) -> launches per main-path call; cone_step's
    rows are (w, round).  ``opening``: the dense adder's initial AND takes
    beaver_and's opening form (trees that have it)."""
    from repro_torch.core.schedule import cone_sets, n_levels

    out = Counter()
    for (n, relus), w in zip(chip_smoke.RELU_GROUPS, chip_smoke.PLAN_WIDTHS[plan]):
        if w < 2:
            continue
        n_words = chip_smoke.STREAMS * n // 32
        if route == "fused":
            rounds = 1 + sum(1 for pos in cone_sets(w)[1] if pos)
            for r in range(rounds):
                out[("cone_step", (w, r), n_words)] += relus
            continue
        if route == "cone":
            init_pos, level_sets = cone_sets(w)
            out[("beaver_and", len(init_pos), n_words)] += relus
            for pos in level_sets:
                if pos:
                    out[("beaver_and", 2 * len(pos), n_words)] += relus
                    out[("ks_level", len(pos), n_words)] += relus
            continue
        out[("beaver_and_open" if opening else "beaver_and", w, n_words)] += relus
        levels = n_levels(w)
        if route == "level":
            for kernel in ("ks_mask", "stack", "ks_combine"):
                out[(kernel, w, n_words)] += relus * levels
        else:
            out[("ks_mask", w, n_words)] += relus
            out[("ks_step", w, n_words)] += relus * (levels - 1)
            out[("ks_combine_g", w, n_words)] += relus
    return out


def call(kernel: str, rows: int, n_words: int, gen):
    """A zero-argument call of one kernel form at one shape, on fresh
    random words (the cone's ks_level at the layout of its first level:
    rows 2, 4, ... of w - 1 = 2 rows + 1 planes; cone_step at its round's
    layout, ``chip_smoke.cone_step_inputs``)."""
    from repro_torch.kernels import ops

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                             dtype=torch.int32, device="cuda")

    sel = torch.tensor([-1, 0], dtype=torch.int32, device="cuda")
    if kernel == "cone_step":
        w, r = rows
        args, level, nxt = chip_smoke.cone_step_inputs(words, w, r, n_words, P)
        g, p = words(P, w - 1, n_words), words(P, w, n_words)
        return lambda: ops.cone_step(*args, sel, g, p, level, *nxt)
    if kernel.startswith("beaver_and"):
        d, e, a, b, c = (words(P, rows, n_words) for _ in range(5))
        if kernel == "beaver_and":
            return lambda: ops.beaver_and(d, e, a, b, c, sel)
        sent, opened = words(P, 2, rows, n_words), words(P, 2, rows, n_words)
        return lambda: ops.beaver_and(sent[:, 0], sent[:, 1], a, b, c, sel,
                                      opened[:, 0], opened[:, 1])
    if kernel == "ks_level":
        g, p = words(P, 2 * rows + 1, n_words), words(P, 2 * rows + 1, n_words)
        z = words(P, 2 * rows, n_words)
        return lambda: ops.ks_level(g, p, z, 2, 2)
    w = rows
    g, p = words(P, w, n_words), words(P, w, n_words)
    a, b, c, a2, b2 = (words(P, 2 * w, n_words) for _ in range(5))
    sent, opened = words(P, 2, 2 * w, n_words), words(P, 2, 2 * w, n_words)
    if kernel == "ks_mask":
        return lambda: ops.ks_mask(g, p, a, b, 1)
    if kernel == "stack":
        d, e = sent[:, 0].contiguous(), sent[:, 1].contiguous()
        return lambda: torch.stack([d, e], dim=1)
    if kernel == "ks_combine":
        return lambda: ops.ks_combine(sent[:, 0].contiguous(), opened[:, 0],
                                      sent[:, 1].contiguous(), opened[:, 1],
                                      a, b, c, sel, g)
    halves = (sent[:, 0], opened[:, 0], sent[:, 1], opened[:, 1])
    if kernel == "ks_combine_g":
        return lambda: ops.ks_combine(*halves, a, b, c, sel, g, need_p=False)
    return lambda: ops.ks_step(sent, opened[:, 0], opened[:, 1], a, b, c, sel, g,
                               a2, b2, 2)


def time_shape(kernel: str, rows: int, n_words: int, flush, gen) -> dict:
    ms, hot_ms = chip_smoke.device_ms(call(kernel, rows, n_words, gen), flush)
    moved = chip_smoke.cone_step_rows(*rows) if kernel == "cone_step" else rows
    bytes_moved = BYTES_PER_ROW_WORD[kernel] * P * moved * n_words
    return {"kernel": kernel, "rows": rows, "words": n_words, "ms": ms,
            "hot_ms": hot_ms,
            "bound_ms": bytes_moved / chip_smoke.HBM_BYTES_PER_S * 1e3}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=ROOT,
                        help="checkout whose src/repro_torch is timed")
    parser.add_argument("--walls", nargs="?", const="exact,reduced", default="",
                        help="also time these plans' online wall (default: "
                             "the dense plans)")
    parser.add_argument("--profile", action="store_true",
                        help="profile one more call of each exact plan timed")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gmw_bench: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.kernels import build, ops

    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    print(f"build: {build.build_all():.1f} s ({build.__file__})", flush=True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda").zero_
    gen = torch.Generator(device="cuda").manual_seed(0)
    routes = ("level", "step") if hasattr(ops, "ks_step") else ("level",)
    cone_routes = ("cone", "fused") if hasattr(ops, "cone_step") else ("cone",)
    opening = "d_other" in inspect.signature(ops.beaver_and).parameters
    counts = {(plan, route): launches(plan, route, opening)
              for plan in chip_smoke.PLAN_WIDTHS
              for route in (cone_routes if plan.endswith("cone") else routes)}
    shapes = sorted(set().union(*counts.values()))
    recs = {shape: time_shape(*shape, flush, gen) for shape in shapes}
    sums = {}
    for (plan, route), count in counts.items():
        kernels = sorted({s[0] for s in count})
        for kernel in kernels + ["all"]:
            mine = {s: c for s, c in count.items() if kernel in (s[0], "all")}
            total = {key: sum(c * recs[s][key] for s, c in mine.items()) for key in KEYS}
            total["launches"] = sum(mine.values())
            sums[f"{plan} {route} {kernel}"] = total
            print(f"{plan:12s} {route:5s} {kernel:12s}: {total['launches']:4d} "
                  f"launches, {total['ms']:.4f} ms from DRAM, {total['hot_ms']:.4f} "
                  f"ms from L2; bound {total['bound_ms']:.4f} ms", flush=True)
    walls = {}
    if args.walls:
        setup = chip_smoke.resnet_setup()
        for name in args.walls.split(","):
            walls[name] = chip_smoke.online_calls(
                name, setup[2][name], setup,
                profile=args.profile and name.startswith("exact"))
    print(json.dumps({"tree": args.tree, "nvidia_smi": smi,
                      "shapes": list(recs.values()), "per_call": sums,
                      "walls": walls}))


if __name__ == "__main__":
    main()
