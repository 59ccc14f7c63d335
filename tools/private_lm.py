#!/usr/bin/env python3
"""Private transformer LM inference end to end on the port (the twin of
``examples/private_lm.py``: same flags and steps, plus ``--device``).

The transformer's nonlinearities lower onto the paper's reduced-ring
machinery (``nn/approx/``): SiLU becomes a closed-form sum of
knot-shifted ReLUs evaluated in one fused pass, softmax becomes
ReLU(scores) with a public causal row-mean, and the secret matmuls
(QK^T, A@V, gate*up) open through fused Beaver rounds.  The traced Plan
prices all of it, and the measured rounds and bytes must equal the
prediction exactly.

    PYTHONPATH=src python tools/private_lm.py                 # on the GPU
    PYTHONPATH=src python tools/private_lm.py --device cpu
    PYTHONPATH=src python tools/private_lm.py --layers 2 --seq 16 --budget 8of64
    PYTHONPATH=src python tools/private_lm.py --arch qwen1.5-0.5b --seq 32

Without ``--device`` it runs on the GPU, and raises where there is none.
The last output line is one JSON object with the schedule's and the
measured rounds and bytes, the error against the plaintext twin and the
served batch's rounds.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch import api, configs  # noqa: E402
from repro_torch.core import MPCTensor, comm as comm_lib, prng  # noqa: E402
from repro_torch.device import resolve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import InferenceEngine  # noqa: E402


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b-smoke",
                    help="registry name of a dense LM config")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--seq", type=int, default=8)
    ap.add_argument("--budget", choices=("baseline", "8of64"), default="baseline",
                    help="per-site (k, m): exact 64-bit ring, or k=22 with 6 low "
                         "bits discarded on the MLP stacks")
    ap.add_argument("--device", default=None,
                    help="torch device (default the GPU; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    # --- setup: a dense LM resolved by registry name -------------------------
    # float32 weights: the dtype the MPC path encodes its weights from
    cfg = dataclasses.replace(configs.get(args.arch), n_layers=args.layers,
                              dtype="float32")
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    # the client embeds tokens locally and secret-shares the hidden states;
    # the server never sees tokens or activations
    h = prng.normal(prng.PRNGKey(1, dev), (1, args.seq, cfg.d_model)) * 0.5

    print(f"[1/3] tracing {cfg.name} ({cfg.n_layers} layer(s), act {cfg.act}, "
          f"seq {args.seq}, on {dev})...", flush=True)
    plan = lm.trace(params, cfg, batch=1, seq=args.seq)
    if args.budget != "baseline":
        # attention scores keep the full reduced ring; the PWL MLP stacks
        # (odd groups) discard 6 low bits
        layers = tuple(api.HBLayer(k=22, m=0) if g % 2 == 0 else api.HBLayer(k=22, m=6)
                       for g in range(plan.hb.n_groups))
        plan = plan.with_hb(api.HBConfig(layers, plan.hb.group_elements))
    sched = plan.schedule()
    print(f"      {len(plan.calls)} ReLU groups + {len(plan.opens)} Beaver opens -> "
          f"{sched.n_rounds} fused rounds, {sched.bytes_tx} B/party "
          f"({sched.bytes_tx / 1e6:.1f} MB; LAN "
          f"{plan.estimate(network=api.LAN) * 1e3:.0f} ms, WAN "
          f"{plan.estimate(network=api.WAN):.1f} s)", flush=True)

    # --- private forward: measured == predicted, exactly ---------------------
    print("[2/3] one private forward (real GMW, sim comm)...", flush=True)

    def afn(p, x, relu_fn=None):
        return lm.mpc_reference(p, x, cfg, relu_fn=relu_fn)

    cc = comm_lib.CoalescingComm(comm_lib.CountingComm())
    model = api.compile(afn, params, cfg, plan, api.Session(key=0, comm=cc, device=dev))
    _sync(dev)
    t0 = time.perf_counter()
    logits = model(model.encrypt(prng.PRNGKey(2, dev), h)).reveal()
    _sync(dev)
    wall = time.perf_counter() - t0
    with torch.no_grad():
        ref = lm.mpc_reference(params, h, cfg)
    err = float((logits - ref).abs().max())
    if (cc.n_rounds, cc.bytes_tx) != (sched.n_rounds, sched.bytes_tx):
        raise AssertionError(f"measured {cc.n_rounds} rounds / {cc.bytes_tx} B, "
                             f"schedule {sched.n_rounds} / {sched.bytes_tx}")
    same = bool(torch.equal(logits[0, -1].argmax(), ref[0, -1].argmax()))
    print(f"      measured {cc.n_rounds} rounds / {cc.bytes_tx} B == schedule "
          f"prediction; max |err| {err:.2e}; next-token argmax "
          f"{'==' if same else '!='} plaintext; {wall / args.seq:.2f} s/token (sim)",
          flush=True)

    # --- serving: the unchanged engine, LM requests like any other -----------
    print("[3/3] serving two LM requests through InferenceEngine...", flush=True)
    engine = InferenceEngine(afn, params, cfg, plan, api.Session(key=0, device=dev))
    xs = [MPCTensor.from_plain(prng.PRNGKey(10 + i, dev), h) for i in range(2)]
    futs = [engine.submit(t, x) for t, x in zip(("alice", "bob"), xs)]
    outs = [f.result() for f in futs]
    rep = engine.reports[0]
    if rep.measured_rounds != rep.predicted_rounds:
        raise AssertionError(f"served batch: measured {rep.measured_rounds} rounds, "
                             f"predicted {rep.predicted_rounds}")
    served_err = max(float((o.reveal() - ref).abs().max()) for o in outs)
    if served_err >= max(2 * err, 1e-2) + 0.05:
        raise AssertionError(f"served logits {served_err} from the plaintext twin")
    print(f"      {rep.n_requests} requests, one fused batch: {rep.measured_rounds} "
          f"rounds (serial would pay {rep.serial_rounds}), saved "
          f"x{rep.rounds_saved_ratio:.1f}", flush=True)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "seq": args.seq,
           "budget": args.budget, "device": str(dev),
           "rounds": sched.n_rounds, "bytes_tx": sched.bytes_tx,
           "measured_rounds": cc.n_rounds, "measured_bytes": cc.bytes_tx,
           "max_abs_err": err, "argmax_equal": same, "wall_s": wall,
           "served_requests": rep.n_requests, "served_rounds": rep.measured_rounds,
           "served_serial_rounds": rep.serial_rounds, "served_max_abs_err": served_err}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
