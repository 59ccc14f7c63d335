#!/usr/bin/env python3
"""Time unpack, pack and pack_ring at every shape that the main path's
triple merges, sign planes and A2B rounds give them, for one checkout's
kernels, and sum them per call, for each route.

    python3 tools/bitpack_bench.py [--tree DIR] [--variant NAME=N[+...]]

``--tree DIR`` uses the ``repro_torch`` package of the checkout at DIR
(default: this one), e.g. ``git archive <commit>`` unpacked into the
gitignored ``build/``, so that two trees' kernels run in turns in one call
on one card (parent, change, change, parent), each in its own process:

    for t in build/parent . . build/parent; do
        python3 tools/bitpack_bench.py --tree $t; done

``--variant`` times a copy of the tree's package whose bitpack.cu has
other values of its pack kernel's constants (``kPackThreads=128``,
``kPackMinWarpWords=8``, ``kPackMinBlocks=1``) or has parts taken out or
replaced (``VARIANTS``: ``no_vec``, ``no_load``, ``ldg``,
``no_transpose``, ``no_store``), joined by '+' (outputs unchecked; the
copy goes to ``build/bitpack_variants/``).

For each of ``chip_smoke.py``'s four plans (full-width ResNet-18, 4
requests as sibling streams) and each ReLU, two routes of the merges:
- ``bit``: the 4 streams' triples merge at the bit level: every binary
  member of every stream is unpacked (a, b and c; one plane per row) and
  the concatenation packed, then the sign plane is unpacked;
- ``word``: the merge concatenates the words (no kernel), and only the
  sign plane is unpacked.
and three of the A2B round's packing (``chip_smoke.PACK_RING_SHAPES``,
one pack_ring per ReLU):
- ``alone``: pack_ring, unmasked;
- ``xor``: pack_ring, then the mask XORed in by torch (two launches, the
  route before the mask was folded into the kernel);
- ``fused``: pack_ring with the mask (trees whose ``ops.pack_ring`` takes
  ``mask``).
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
import inspect
import json
import os
import re
import shutil
import sys
from collections import Counter

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (after the path: it sits at the repo root)

P = 2
KEYS = chip_smoke.SUM_KEYS
RING_ROUTES = {"alone": 1, "xor": 2, "fused": 1}     # device launches per ReLU
# parts of the pack kernel a variant takes out or replaces (bitpack.cu's
# text -> the variant's); outputs unchecked
_VALUE_COPIES = ("cp_async<16>(vals + c * kPer, e < n ? row_vals + e : row_vals, e < n);",
                 "cp_async<sizeof(T)>(vals + c, e < n ? row_vals + e : row_vals, e < n);")
VARIANTS = {
    # one-value copies only: no 16-byte cp.async
    "no_vec": [("const bool vec_vals = aligned(v)", "const bool vec_vals = false")],
    # the values' copies issued but nothing else of the load path
    "no_load": [(c, "") for c in _VALUE_COPIES],
    # values loaded into registers with plain loads, not copied ahead
    "ldg": [(c, "") for c in _VALUE_COPIES] + [(
        "x[g] = static_cast<uint64_t>(vals[buf * kWords * 32 + (g0 + g) * 32 + lane])\n"
        "          >> shift;",
        "const int64_t e = (j0 + g0 + g) * 32 + lane;\n"
        "      x[g] = e < n ? static_cast<uint64_t>(v[row * n + e]) >> shift : 0u;")],
    "no_transpose": [("for (int q = 0; q < kT; ++q) bits[q] = transpose32(bits[q], lane);",
                      "")],
    "no_store": [("*reinterpret_cast<uint4*>(dst + p * words + g) = o;",
                  "if (o.x == 0x9e3779b9u && o.y == o.z) "
                  "*reinterpret_cast<uint4*>(dst + p * words + g) = o;"),
                 ("dst[p * words + g] = o;",
                  "if (o == 0x9e3779b9u) dst[p * words + g] = o;")],
}


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


def time_pack_ring(route: str, k: int, m: int, e: int, flush, gen) -> dict:
    from repro_torch.kernels import ops

    w, n_words = k - m, (e + 31) // 32
    x = torch.randint(-2 ** 63, 2 ** 63 - 1, (P, e), generator=gen,
                      dtype=torch.int64, device="cuda")
    r = torch.randint(-2 ** 31, 2 ** 31 - 1, (P, w, n_words), generator=gen,
                      dtype=torch.int32, device="cuda")
    fn = {"alone": lambda: ops.pack_ring(x, k, m),
          "xor": lambda: ops.pack_ring(x, k, m) ^ r,
          "fused": lambda: ops.pack_ring(x, k, m, mask=r)}[route]
    words_bytes = {"alone": 4, "xor": 16, "fused": 8}[route] * r.numel()
    ms, hot_ms = chip_smoke.device_ms(fn, flush)
    return {"kernel": "pack_ring", "route": route, "k": k, "m": m, "n": e,
            "ms": ms, "hot_ms": hot_ms, "eager_call_ms": chip_smoke.eager_ms(fn),
            "bound_ms": (8 * x.numel() + words_bytes) / chip_smoke.HBM_BYTES_PER_S * 1e3}


def make_variant(tree: str, spec: str) -> str:
    """A copy of ``tree``'s package whose bitpack.cu has the constants and
    parts of ``spec`` (``NAME=N`` or a name of ``VARIANTS``, joined by
    '+'); returns its root."""
    out = os.path.join(ROOT, "build", "bitpack_variants", spec)
    src = os.path.join(out, "src", "repro_torch")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "src", "repro_torch"), src,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = os.path.join(src, "csrc", "bitpack.cu")
    with open(cu) as f:
        text = f.read()
    for part in spec.split("+"):
        if "=" in part:
            name, value = part.split("=")
            text, count = re.subn(rf"constexpr int {name} = \d+;",
                                  f"constexpr int {name} = {int(value)};", text)
            swaps = [] if count == 1 else [(name, None)]
        else:
            swaps = VARIANTS[part]
        for old, new in swaps:
            if new is None or text.count(old) != 1:
                raise SystemExit(f"variant {part}: its text is not once in {cu}")
            text = text.replace(old, new)
    with open(cu, "w") as f:
        f.write(text)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=ROOT,
                        help="checkout whose src/repro_torch is timed")
    parser.add_argument("--variant", default="",
                        help="pack kernel constants NAME=N or parts ("
                        + ", ".join(VARIANTS) + "), joined by '+'")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bitpack_bench: torch.cuda.is_available() is false")
    tree = os.path.abspath(args.tree)
    pkg_root = make_variant(tree, args.variant) if args.variant else tree
    sys.path.insert(0, os.path.join(pkg_root, "src"))
    from repro_torch.kernels import build, ops

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
    routes = [r for r in RING_ROUTES
              if r != "fused" or "mask" in inspect.signature(ops.pack_ring).parameters]
    ring = {(route,) + shape: time_pack_ring(route, *shape, flush, gen)
            for route in routes for shape in chip_smoke.PACK_RING_SHAPES}
    for rec in ring.values():
        print(f"pack_ring {rec['route']:5s} (k, m) = ({rec['k']}, {rec['m']}) E = "
              f"{rec['n']}: {rec['ms']:.4f} ms from DRAM, {rec['hot_ms']:.4f} ms "
              f"from L2, {rec['eager_call_ms']:.4f} ms eager; bound "
              f"{rec['bound_ms']:.4f} ms", flush=True)
    for plan in chip_smoke.PLAN_WIDTHS:
        for route in routes:
            per_shape = {(route,) + s: c
                         for s, c in chip_smoke.pack_ring_launches(plan).items()}
            total = chip_smoke.call_sums(ring, per_shape)
            total["launches"] *= RING_ROUTES[route]
            sums[f"{plan} {route} pack_ring"] = total
            print(f"{plan:12s} pack_ring {route:5s}: {total['launches']:3d} "
                  f"launches, {total['ms']:.4f} ms from DRAM, {total['hot_ms']:.4f} "
                  f"ms from L2, {total['eager_call_ms']:.4f} ms eager; bound "
                  f"{total['bound_ms']:.4f} ms", flush=True)
    print(json.dumps({"tree": args.tree, "variant": args.variant, "nvidia_smi": smi,
                      "shapes": list(recs.values()) + list(ring.values()),
                      "per_call": sums}))


if __name__ == "__main__":
    main()
