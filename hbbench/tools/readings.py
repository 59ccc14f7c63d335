"""The readings a cell's limits are set from, in one process on the card:
per seed, the program's numbers (a sound run) and its requests' errors,
the control's (the program with its inputs shared at
``CONTROL_FRAC_BITS`` fractional bits in place of 16, which every later
fixed-point step follows), and the plain reference's in TF32 on the same
calls; with the window's latencies and the garbage collector's pauses.

    python hbbench/tools/readings.py --workload <cell> --seconds 3 --seeds S1 S2 ...

Prints one JSON line per seed.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

CONTROL_FRAC_BITS = 12


class _GCPauses:
    """Seconds each collection took, by generation, while installed."""

    def __init__(self):
        self.pauses = {0: [], 1: [], 2: []}
        self._t = 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.pauses[info["generation"]].append(time.perf_counter() - self._t)

    def summary(self):
        return {g: [len(p), round(sum(p), 4), round(max(p, default=0.0), 4)]
                for g, p in self.pauses.items()}


def tf32_reading(cell, seed: int, calls, device) -> dict:
    """The plain reference in TF32 held to the float32 reference, request
    by request as the program is."""
    import torch
    from hbbench.lib import harness

    want = {i: w.cpu() for i, w in harness.reference_logits(cell, seed, calls, device)}
    weights = cell.model.make_weights(cell.cfg, seed, device)
    clients = int(cell.workload["clients"])
    got = {}
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            for i in calls:
                xs = cell.model.make_inputs(cell.cfg, seed, i, clients, device)
                got[i] = cell.reference.forward(cell.cfg, weights, torch.cat(xs)).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    req = harness.request_errors(got, want.items())
    return harness.error_summary(req["errors"], cell.workload["check"]["request_err"])


def readings(name: str, seed: int, seconds: float, device="cuda",
             control: bool = True) -> dict:
    from hbbench.lib import cell as cell_lib, harness

    cell = cell_lib.find(name)
    pauses = _GCPauses()
    gc.callbacks.append(pauses)
    try:
        result, rec = harness.run(cell, seed, seconds, False, device)
    finally:
        gc.callbacks.remove(pauses)
    lat = sorted(c["latency_s"] for c in rec["window"]["calls"])
    out = {"workload": name, "seed": seed, "correct": result["correct"],
           "program": {k: c["value"] for k, c in result["checks"].items()},
           "program_errors": rec["errors"],
           "tf32_errors": tf32_reading(cell, seed, rec["checked_calls"], device),
           "calls_checked": len(rec["checked_calls"]), "attempted": result["attempted"],
           "metrics": {k: m["value"] for k, m in result["metrics"].items()},
           "setup_split": rec["setup_split"],
           "latency_s": [lat[0], lat[len(lat) // 2], lat[int(0.95 * len(lat))], lat[-1]],
           "gc_pauses": pauses.summary()}
    if control:
        ctrl, crec = harness.run(cell, seed, seconds, False, device,
                                 frac_bits=CONTROL_FRAC_BITS)
        out["control"] = {k: c["value"] for k, c in ctrl["checks"].items()}
        out["control_errors"] = crec["errors"]
        out["control_correct"] = ctrl["correct"]
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args()
    import torch
    torch.set_num_threads(1)     # as hbbench/run.py
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds,
                                  control=not args.no_control)), flush=True)


if __name__ == "__main__":
    main()
