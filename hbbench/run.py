"""Run one cell of the port's benchmark once.

    python hbbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  With ``--trace 0`` the last line of standard
output is the result with the cell's end-to-end metrics; with ``--trace
1`` its per-layer metrics, the device's busy and window seconds and a
breakdown.  The numbers the check compared close both standard error and
the result line.  Exits non-zero, printing no result, without as many
CUDA devices as the cell asks for, when the program cannot be imported, or
when a JAX module was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _by_sixths(win, clients: int):
    """Requests completed in each sixth of the window over its length: a
    drift through the window shows as a trend."""
    sixth = win["seconds"] / 6
    counts = [0] * 6
    for c in win["calls"]:
        counts[min(5, int(c["end_s"] / sixth))] += clients
    return [round(n / sixth, 2) for n in counts]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)     # one process, one host thread for torch's CPU ops
    from hbbench.lib import cell as cell_lib, harness

    cell = cell_lib.find(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"hbbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, rec = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                              "cuda", T_START)
    banned = harness.banned_modules()
    if banned:
        print(f"hbbench: modules of JAX or of the JAX package were loaded: {banned}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": rec["peak_bytes"],
              "power": _power_limit()}
    if args.trace:
        stretch = rec.get("stretch") or {}
        device["busy_s"] = stretch.get("busy_us", 0.0) / 1e6
        device["window_s"] = stretch.get("span_us", 0.0) / 1e6
    lat = sorted(c["latency_s"] for c in rec["window"]["calls"])
    print(f"hbbench: set-up {rec['setup_s']:.3f} s: "
          + ", ".join(f"{k} {v:.3f}" for k, v in rec["setup_split"].items())
          + f"; {len(lat)} calls, latency s min {lat[0]:.4f} median "
          f"{lat[len(lat) // 2]:.4f} max {lat[-1]:.4f}", file=sys.stderr)
    print("hbbench: requests/s by sixths of the window "
          f"{_by_sixths(rec['window'], rec['clients'])}", file=sys.stderr)
    print(f"hbbench: request errors (largest logit gap over the logits' RMS) "
          f"{rec['errors']}, limit per request {cell.workload['check']['request_err']!r}",
          file=sys.stderr)
    checks = result.pop("checks")
    result["device"] = device
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
