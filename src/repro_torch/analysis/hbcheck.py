"""hbcheck CLI for the port: the protocol-safety gate (twin of the
reference's ``analysis/hbcheck.py``).

Runs, in one invocation:

1. the AST protocol linter (rules R001-R006, ``analysis.lint``) over the
   given paths; the rules apply to files of the ``repro_torch`` package,
   and the other default paths (the port's tests, ``chip_smoke.py``, its
   ``tools/`` scripts) get only the syntax check (R000),
2. the lock-discipline checker for the port's serving engine and
   frontend (``analysis.locks``),
3. the leakage census over the comm seam (``analysis.census``): on the
   card (the default, as every entry point of the port) full-width
   ResNet-18 under the exact and reduced plans; with ``--device cpu`` the
   smoke fixture (``RESNET_SMOKE``, the reduced plan),
4. ``ruff check`` with the repo's pyproject config, when ruff is
   installed.

Usage::

    python -m repro_torch.analysis.hbcheck --check               # on the card
    python -m repro_torch.analysis.hbcheck --check --device cpu

``--check`` makes the exit code a gate: non-zero on any non-baselined
finding, any unmasked round, a census whose rounds or bytes differ from
the schedule or that could not run, or a ruff failure.  Without it the
run only reports.  ``--update-baseline`` rewrites
``tools/hbcheck_torch_baseline.json`` (never the reference's baseline)
with the current findings.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys
from typing import List

from . import lint as lint_lib
from . import locks as locks_lib

DEFAULT_BASELINE = "tools/hbcheck_torch_baseline.json"
REFERENCE_TOOLS = ("docs_smoke.py",)       # tools/ scripts of the JAX package


def default_paths(root=".") -> List[str]:
    """The port's own files: the package, its tests, ``chip_smoke.py`` and
    its ``tools/`` scripts (those present under ``root``).  Outside the
    package only the syntax check (R000) reaches them."""
    root = pathlib.Path(root)
    tests = sorted(root.glob("tests/test_torch_*.py")) + [
        root / "tests" / "torch_mesh_ranks.py", root / "tests" / "conftest.py"]
    tools = [t for t in sorted(root.glob("tools/*.py"))
             if t.name not in REFERENCE_TOOLS]
    paths = [root / "src" / "repro_torch", *tests, root / "chip_smoke.py", *tools]
    return [str(p) for p in paths if p.exists()]


def _run_census(device) -> dict:
    """The canonical census's summary, or ``{"error": ...}`` when it could
    not run (which fails ``--check``)."""
    try:
        from . import census as census_lib
        return census_lib.canonical_resnet_census(device)
    except Exception as e:                      # reported, never swallowed
        return {"error": f"{type(e).__name__}: {e}"}


def _run_ruff(paths: List[str]) -> dict:
    if shutil.which("ruff") is None:
        return {"skipped": "ruff not installed"}
    proc = subprocess.run(["ruff", "check", *paths],
                          capture_output=True, text=True)
    return {"returncode": proc.returncode,
            "output": (proc.stdout + proc.stderr).strip()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.hbcheck",
        description="HummingBird protocol-safety gate for the PyTorch port")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to lint (default: the port's "
                         "package, tests, chip_smoke.py and tools)")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero on any non-baselined finding, "
                         "unmasked round, failed census or ruff failure")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help=f"grandfathered-findings file (default "
                         f"{DEFAULT_BASELINE})")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline with the current findings")
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="where the census runs: cuda (the default; "
                         "full-width ResNet-18) or cpu (smoke fixture)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report on stdout")
    ap.add_argument("--no-census", action="store_true",
                    help="skip the leakage census")
    ap.add_argument("--no-locks", action="store_true",
                    help="skip the serve-engine lock-discipline check")
    ap.add_argument("--no-ruff", action="store_true",
                    help="skip the ruff hygiene pass")
    args = ap.parse_args(argv)
    paths = args.paths or default_paths()

    findings = lint_lib.lint_paths(paths)
    if not args.no_locks:
        findings.extend(locks_lib.check_paths("."))
    findings.sort(key=lambda f: (f.file, f.line, f.rule))

    if args.update_baseline:
        if pathlib.Path(args.baseline).resolve() == \
                pathlib.Path("tools/hbcheck_baseline.json").resolve():
            print("hbcheck: refusing to write the reference's baseline",
                  file=sys.stderr)
            return 2
        lint_lib.save_baseline(args.baseline, findings)
        print(f"baseline rewritten: {len(findings)} entries -> "
              f"{args.baseline}")
        return 0

    baseline = lint_lib.load_baseline(args.baseline)
    new = [f for f in findings if f.key() not in baseline]
    baselined = len(findings) - len(new)

    census = ({"skipped": "--no-census"} if args.no_census
              else _run_census(args.device))
    ruff = {"skipped": "--no-ruff"} if args.no_ruff else _run_ruff(paths)

    census_bad = "error" in census or (
        "skipped" not in census
        and (census["unmasked_collectives"] != 0 or not census["cross_check_ok"]))
    ruff_bad = ruff.get("returncode", 0) != 0
    failed = bool(new) or census_bad or ruff_bad

    if args.as_json:
        print(json.dumps({
            "findings": [vars(f) for f in new],
            "baselined": baselined,
            "census": census,
            "ruff": ruff,
            "ok": not failed,
        }, indent=1))
    else:
        for f in new:
            print(f)
        if ruff_bad:
            print(ruff["output"])
        status = [f"lint+locks: {len(new)} finding(s)"
                  + (f" ({baselined} baselined)" if baselined else "")]
        if "skipped" in census:
            status.append(f"census: skipped ({census['skipped']})")
        elif "error" in census:
            status.append(f"census: FAILED ({census['error']})")
        else:
            status.append(
                f"census ({args.device or 'cuda'}): {census['collectives']} rounds "
                f"({census['masked_collectives']} masked, "
                f"{census['public_collectives']} public, "
                f"{census['unmasked_collectives']} unmasked), "
                f"{census['bytes']} B a party; schedule "
                f"{census['sched_rounds']} / {census['sched_bytes']} B: "
                f"{'ok' if census['cross_check_ok'] else 'FAILED'}")
        if "skipped" in ruff:
            status.append(f"ruff: skipped ({ruff['skipped']})")
        else:
            status.append("ruff: " + ("ok" if not ruff_bad else "FAILED"))
        print("hbcheck: " + "; ".join(status))

    if args.check and failed:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
