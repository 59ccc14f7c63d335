#!/usr/bin/env python3
"""Quickstart on the port: secret-share a tensor, run HummingBird ReLU, see
the communication savings (the twin of ``examples/quickstart.py``: same
steps and keys, plus ``--device``).

    PYTHONPATH=src python tools/quickstart.py                # on the GPU
    PYTHONPATH=src python tools/quickstart.py --device cpu

Without ``--device`` it runs on the GPU, and raises where there is none.
The last output line is one JSON object with the revealed values, party
0's share words and the priced bytes and rounds.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402

from repro_torch.core import HBLayer, MPCTensor, costmodel, prng, ring  # noqa: E402
from repro_torch.device import resolve  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default the GPU; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    # the client's plaintext is drawn on the host, so that every device
    # shares the same floats (torch's erfinv differs by ulps between them)
    x = (prng.normal(prng.PRNGKey(0, "cpu"), (8,)) * 3.0).to(dev)
    print("plaintext x:   ", np.round(x.cpu().numpy(), 3))

    # 1. secret-share: neither party's share reveals anything about x
    X = MPCTensor.from_plain(prng.PRNGKey(1, dev), x)
    lo, hi = ring.to_limbs(X.data)            # the reference's uint32 limbs
    print("party 0 share: ", lo[0][:4], "... (uniform)")

    # 2. exact CrypTen-style ReLU on the full 64-bit ring
    exact = X.relu(prng.PRNGKey(2, dev), hb=HBLayer(k=64, m=0))
    exact_np = exact.reveal_np()
    print("exact ReLU:    ", np.round(exact_np, 3))

    # 3. HummingBird: estimate the sign with only 8 of the 64 bits
    hb = HBLayer(k=21, m=13)
    approx = X.relu(prng.PRNGKey(3, dev), hb=hb)
    approx_np = approx.reveal_np()
    print(f"HB ReLU [k={hb.k},m={hb.m}]:", np.round(approx_np, 3))

    # 4. what did that buy? (per-party bytes on the wire)
    base = costmodel.relu_cost(x.numel(), 64)
    ours = costmodel.relu_cost(x.numel(), hb.width)
    print(f"\ncommunication: {base.bytes_tx} B -> {ours.bytes_tx} B "
          f"({base.bytes_tx / ours.bytes_tx:.2f}x less), "
          f"rounds {base.rounds} -> {ours.rounds}")
    print("Theorem 2 pruning threshold:",
          f"|x| < 2^({hb.m}-16) = {2.0 ** (hb.m - 16)}")
    out = {"device": str(dev), "x": x.cpu().tolist(),
           "share0_lo": lo[0].tolist(), "share0_hi": hi[0].tolist(),
           "exact": exact_np.tolist(), "hb": approx_np.tolist(),
           "exact_shares": ring.to_uint64_np(exact.data).tolist(),
           "hb_shares": ring.to_uint64_np(approx.data).tolist(),
           "k": hb.k, "m": hb.m,
           "bytes_exact": base.bytes_tx, "bytes_hb": ours.bytes_tx,
           "rounds_exact": base.rounds, "rounds_hb": ours.rounds,
           "threshold": 2.0 ** (hb.m - 16)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
