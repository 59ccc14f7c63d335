"""How many elements local share truncation is expected to wrap in one
request of a cell: over every element the program truncates in a call,
the sum of |x| / 2^64, x being the ring value its two shares hold, which
is the chance that SecureML's local truncation of that element wraps.
Runs the program on the generator loop, where every truncation is a
Python call, and counts the calls after the warm one.

    python hbbench/tools/wraps.py --workload <cell> --seeds S1 S2 ... [--calls 2]

Prints one JSON line per seed: expected wraps per request and the chance
that a check of ``n`` requests sees more than 0, 1, 2 or 3 of them wrong.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _more_than(k: int, n: int, p: float) -> float:
    return 1.0 - sum(math.comb(n, j) * p ** j * (1 - p) ** (n - j) for j in range(k + 1))


def expected(name: str, seed: int, calls: int, checked: int, device="cuda") -> dict:
    os.environ["HB_ROUND_LOOP"] = "python"
    import torch
    from hbbench.lib import cell as cell_lib
    from hbbench.lib.program import Program
    from repro_torch.core import mpc_tensor, shares

    cell = cell_lib.find(name)
    prog = Program(cell, seed, device)
    prog.call(-1)
    acc = {"lam": 0.0, "elements": 0}
    plain = mpc_tensor.MPCTensor.truncate

    def counting(self, n=None):
        x = shares.reconstruct(self.data)
        acc["lam"] += float(x.abs().double().sum()) / 2.0 ** 64
        acc["elements"] += x.numel()
        return plain(self, n)

    mpc_tensor.MPCTensor.truncate = counting
    try:
        for i in range(calls):
            prog.call(i)
    finally:
        mpc_tensor.MPCTensor.truncate = plain
    prog.close()
    torch.cuda.empty_cache()
    requests = calls * prog.clients
    lam = acc["lam"] / requests
    p = 1.0 - math.exp(-lam)
    return {"workload": name, "seed": seed, "requests": requests,
            "truncated_per_request": acc["elements"] / requests,
            "wraps_per_request": lam, "checked": checked,
            "p_more_than": {k: _more_than(k, checked, p) for k in range(4)}}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--checked", type=int, default=12)
    args = ap.parse_args()
    import torch
    torch.set_num_threads(1)
    for seed in args.seeds:
        print(json.dumps(expected(args.workload, seed, args.calls, args.checked)), flush=True)


if __name__ == "__main__":
    main()
