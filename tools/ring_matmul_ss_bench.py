#!/usr/bin/env python3
"""Time the ring_matmul_ss kernel alone at its LM-path shapes (both LM
paths') and at ``chip_smoke.RING_MATMUL_SS_OTHER_SHAPES`` on one GPU: one checkout's
kernel, or a variant of it with one part taken out.

    python3 tools/ring_matmul_ss_bench.py [--tree DIR] [--variant NAME[+NAME...]]
                                          [--forms]

``--tree DIR`` uses the ``repro_torch`` package of the checkout at DIR
(default: this one), e.g. ``git archive <commit>`` unpacked into the
gitignored ``build/``, so that two trees' kernels run in turns in one call
on one card (parent, change, change, parent), each in its own process:

    for t in build/parent . . build/parent; do
        python3 tools/ring_matmul_ss_bench.py --tree $t; done

Each output is checked equal to ``ref.ring_matmul_ss`` with full-range
values, and timed, as in ``chip_smoke.py`` (``ring_matmul_ss_phase``: cold
from device memory, hot from L2, eager; the plain version; the card
bound; 36 x B ``torch._int_mm`` as a yardstick).  The LM shapes' sum per
LM call weighs each by its launches per call (``LM_SS_PER_CALL``; the
512-token path's reduced call, ``LM_LONG_SS_PER_CALL``).

``--forms`` also times each shape in both of the kernel's forms
(``ops.ring_matmul_ss(x, y, form=...)``, trees that have them), checked.

``--variant`` copies DIR's package to ``build/ring_matmul_ss_variants/``,
changes the named parts of its ``ring_matmul_ss.cu`` (``VARIANTS``),
builds that and times it: an ablation that shows what each part costs.
Its outputs are wrong by design and are not checked.

One JSON line with every record and the sum per LM call is printed and
appended to ``chiprun_out/ring_matmul_ss_bench.jsonl``.
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

# ring_matmul_ss's launches per LM call by shape (B, M, K, N), as
# chip_smoke.lm_shape_launches reads them from the LM plans: 2 layers x 2
# streams of the QK^T and A@V triples (C = A @ B) and Beaver combines
LM_SS_PER_CALL = {(16, 8, 64, 8): 4, (32, 8, 128, 8): 4, (16, 8, 8, 64): 4,
                  (32, 8, 16, 64): 4}
# the same per call of the long LM path's reduced plan: 2 layers x 1
# stream of 512 tokens (the large form's shapes)
LM_LONG_SS_PER_CALL = {(16, 512, 64, 512): 2, (32, 512, 128, 512): 2,
                       (16, 512, 512, 64): 2, (32, 512, 1024, 64): 2}

# name -> (text of csrc/ring_matmul_ss.cu, what replaces it)
VARIANTS = {
    # the large form's wgmmas: a cheap op on the same registers instead
    "no_wgmma": ("wgmma_u8(acc[i + j], a[i], b_desc(yb + j * kYPlane, BN * 16, 128));",
                 "acc[i + j][j] += a[i][0];"),
    # the large form's rewrite of the raw tiles into planes, in the loop
    "no_planes": ("if (du < sh.units) {\n        make_planes(",
                  "if (false) {\n        make_planes("),
    # the large form's loads after the pipeline's first stages
    "no_load": ("if (lu < sh.units) {               // into the stage step q emptied",
                "if (false) {"),
    # three stages of raw tiles instead of four (160 KB of shared memory)
    "stages3": ("constexpr int kStages = 4;", "constexpr int kStages = 3;"),
    # split-K where the tiles do not fill the card (the 4096 cap stays)
    "split1": ("const int64_t fill = room / tiles;", "const int64_t fill = 1;"),
    # the small form's tensor-core products
    "small_no_mma": ("mma_u8u8(c, a[i], b[j]);", "c[0] += a[i][0] ^ b[j][0];"),
    # the 4096 cap on a unit's K: a broken kernel, for showing that
    # tests/test_torch_cuda.py crosses the split (not for timing)
    "no_split_cap": ("if (c > kMaxSteps) c = kMaxSteps;", ""),
}


def make_variant(tree: str, names: str) -> str:
    """A copy of ``tree``'s package with the named parts of
    ring_matmul_ss.cu changed; returns the copy's root."""
    out = os.path.join(ROOT, "build", "ring_matmul_ss_variants", names)
    src = os.path.join(out, "src", "repro_torch")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "src", "repro_torch"), src,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = os.path.join(src, "csrc", "ring_matmul_ss.cu")
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


def lm_sum(recs: list, per_call: dict) -> dict:
    """Launches x ms (cold, hot, eager) and x bound, summed per LM call."""
    by_shape = {r["lm_shape"]: r for r in recs if "lm_shape" in r}
    return chip_smoke.call_sums(by_shape, per_call)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=ROOT,
                        help="checkout whose src/repro_torch is timed")
    parser.add_argument("--variant", default="",
                        help="parts to change, joined by '+': " + ", ".join(VARIANTS))
    parser.add_argument("--forms", action="store_true",
                        help="also time both forms of the kernel at each shape")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ring_matmul_ss_bench: torch.cuda.is_available() is false")
    tree = os.path.abspath(args.tree)
    pkg_root = make_variant(tree, args.variant) if args.variant else tree
    sys.path.insert(0, os.path.join(pkg_root, "src"))
    from repro_torch.kernels import build, ops, ref

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

    chip_smoke.ring_matmul_ss_phase(unchecked if args.variant else checked,
                                    torch.Generator().manual_seed(0),
                                    dict.fromkeys((*LM_SS_PER_CALL,
                                                   *LM_LONG_SS_PER_CALL), "lm"))
    sums = {}
    for what, per_call in (("LM", LM_SS_PER_CALL),
                           ("512-token reduced LM", LM_LONG_SS_PER_CALL)):
        sums[what] = s = lm_sum(recs, per_call)
        print(f"ring_matmul_ss per {what} call ({s['launches']} launches): "
              f"{s['ms']:.4f} ms from DRAM, {s['hot_ms']:.4f} ms from L2, "
              f"{s['eager_call_ms']:.4f} ms eager; card bound {s['bound_ms']:.4f} ms",
              flush=True)
    forms = []
    if args.forms:
        gen = torch.Generator().manual_seed(1)
        for b, m, k, n in (*LM_SS_PER_CALL, *LM_LONG_SS_PER_CALL,
                           *chip_smoke.RING_MATMUL_SS_OTHER_SHAPES):
            x = torch.randint(-2 ** 63, 2 ** 63 - 1, (b, m, k), generator=gen,
                              dtype=torch.int64).cuda()
            y = torch.randint(-2 ** 63, 2 ** 63 - 1, (b, k, n), generator=gen,
                              dtype=torch.int64).cuda()
            want = ref.ring_matmul_ss(x, y)
            for form in ops.SS_FORMS:
                def fn(form=form):
                    return ops.ring_matmul_ss(x, y, form=form)
                if not torch.equal(fn(), want):
                    raise AssertionError(f"form {form} at {(b, m, k, n)} differs")
                ms, hot_ms = chip_smoke.device_ms(fn, scratch.zero_)
                forms.append({"shape": f"B={b} M={m} K={k} N={n}", "form": form,
                              "chosen": form == ops.ss_form(m), "ms": ms,
                              "hot_ms": hot_ms})
                print(f"form {form} [B={b} M={m} K={k} N={n}]"
                      f"{' (chosen)' if forms[-1]['chosen'] else ''}: {ms:.4f} ms "
                      f"from DRAM, {hot_ms:.4f} ms from L2", flush=True)
    line = json.dumps({"tree": args.tree, "variant": args.variant, "nvidia_smi": smi,
                       "ring_matmul_ss": recs, "lm_per_call": sums, "forms": forms})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ring_matmul_ss_bench.jsonl"), "a") as f:
        f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
