#!/usr/bin/env python3
"""Time the ring_matmul kernel alone at its 12 main-path shapes on one GPU:
one checkout's kernel, or a variant of it with one part taken out.

    python3 tools/ring_matmul_bench.py [--tree DIR] [--variant NAME[+NAME...]]

``--tree DIR`` uses the ``repro_torch`` package of the checkout at DIR
(default: this one), e.g. ``git archive <commit>`` unpacked into the
gitignored ``build/``, so that two trees' kernels run in turns in one call
on one card (parent, change, change, parent), each in its own process:

    for t in build/parent . . build/parent; do
        python3 tools/ring_matmul_bench.py --tree $t; done

Each output is checked equal to ``ref.ring_matmul`` with full-range
weights, as in ``chip_smoke.py``.

``--variant`` copies DIR's package to ``build/ring_matmul_variants/``,
takes the named parts out of its ``ring_matmul.cu`` (``VARIANTS``), builds
that and times it: an ablation that shows what each part costs.  Its
outputs are wrong by design and are not checked.

The shapes, the inputs, the timing (cold from device memory, hot from L2,
eager) and the card bound are ``chip_smoke.py``'s.  One JSON line with
every shape's record and the sums per main-path call is printed and
appended to ``chiprun_out/ring_matmul_bench.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (after the path: it sits at the repo root)

# name -> (text of csrc/ring_matmul.cu, what replaces it)
VARIANTS = {
    # the tensor-core products: a cheap op on the same fragments instead
    "no_mma": ("mma_u8s8(acc[i + j][mi][nt], a[mi], b[j][nt]);",
               "acc[i + j][mi][nt][0] += a[mi].x ^ b[j][nt][0];"),
    # the rewrite of the raw tiles into digit planes, in the loop
    "no_digits": ("if (kt + 1 < n_steps)\n      make_digits(",
                  "if (false)\n      make_digits("),
    # the loads after the pipeline's first stages
    "no_load": ("if (next < n_steps)\n      load_stage(",
                "if (false)\n      load_stage("),
    # split-K's 64-bit atomic adds (the output memset stays)
    "no_atomic": ("if (atomic)\n          atomicAdd(",
                  "if (false)\n          atomicAdd("),
    # split-K itself: one block per output tile unless K passes the fold
    "split1": ("const int64_t room = static_cast<int64_t>(sms) * blocks_per_sm[dev] "
               "/ (m_tiles * n_tiles);",
               "const int64_t room = 1;"),
    # the int32 fold: a broken kernel, for showing that
    # tests/test_torch_cuda.py crosses the fold (not for timing)
    "no_fold": ("if (chunk > kFoldSteps) chunk = kFoldSteps;", ""),
}


def make_variant(tree: str, names: str) -> str:
    """A copy of ``tree``'s package with the named parts of ring_matmul.cu
    taken out; returns the copy's root."""
    out = os.path.join(ROOT, "build", "ring_matmul_variants", names)
    src = os.path.join(out, "src", "repro_torch")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "src", "repro_torch"), src,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = os.path.join(src, "csrc", "ring_matmul.cu")
    with open(cu) as f:
        text = f.read()
    for name in names.split("+"):
        old, new = VARIANTS[name]
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: its text is not once in {cu}")
        text = text.replace(old, new)
    with open(cu, "w") as f:
        f.write(text)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=ROOT,
                        help="checkout whose src/repro_torch is timed")
    parser.add_argument("--variant", default="",
                        help="parts to take out, joined by '+': "
                        + ", ".join(VARIANTS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ring_matmul_bench: torch.cuda.is_available() is false")
    tree = os.path.abspath(args.tree)
    pkg_root = make_variant(tree, args.variant) if args.variant else tree
    sys.path.insert(0, os.path.join(pkg_root, "src"))
    from repro_torch.kernels import build

    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    print(f"build: {build.build_all():.1f} s ({build.__file__})", flush=True)
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    recs = []

    def unchecked(name, source, replaces, fn, plain, bytes_moved, ops_s=0.0,
                  shape="", **_):
        ms, hot_ms = chip_smoke.device_ms(fn, scratch.zero_)
        bytes_s = bytes_moved / chip_smoke.HBM_BYTES_PER_S
        recs.append({"name": name, "shape": shape, "ms": ms, "hot_ms": hot_ms,
                     "eager_call_ms": chip_smoke.eager_ms(fn),
                     "bound_ms": max(bytes_s, ops_s) * 1e3})
        print(f"{args.variant} [{shape}]: {ms:.4f} ms from DRAM, "
              f"{hot_ms:.4f} ms from L2", flush=True)
        return recs[-1]

    def checked(*a, **kw):
        return chip_smoke.timed_record(recs, scratch.zero_, *a, **kw)

    chip_smoke.ring_matmul_phase(unchecked if args.variant else checked,
                                 torch.Generator().manual_seed(0))
    line = json.dumps({"tree": args.tree, "variant": args.variant,
                       "nvidia_smi": smi, "ring_matmul": recs})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ring_matmul_bench.jsonl"), "a") as f:
        f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
