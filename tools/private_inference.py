#!/usr/bin/env python3
"""End-to-end private inference on the port (the twin of
``examples/private_inference.py``: same flags, data, epochs, learning
rates and keys, plus ``--device``): train a ResNet, run the HummingBird
offline phase (search + finetune), then serve batched private inference
requests through the real GMW protocol via the Plan/Session/compile API
and report accuracy + communication against the exact baseline.

The offline artifact is a first-class ``repro_torch.api.Plan``: pass
--plan-out to save the searched plan as JSON and --plan-in to reuse it in
a later run (skipping the search).

    PYTHONPATH=src python tools/private_inference.py [--requests 16]
    PYTHONPATH=src python tools/private_inference.py --plan-out plan.json
    PYTHONPATH=src python tools/private_inference.py --plan-in plan.json
    PYTHONPATH=src python tools/private_inference.py --objective latency --network wan
    PYTHONPATH=src python tools/private_inference.py --device cpu

Without ``--device`` it runs on the GPU, and raises where there is none.
The last output line is one JSON object with the figures it printed.
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

from repro_torch import api  # noqa: E402
from repro_torch.configs import RESNET_SMOKE  # noqa: E402
from repro_torch.core import costmodel, prng  # noqa: E402
from repro_torch.data import ImagePipeline  # noqa: E402
from repro_torch.device import resolve  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from repro_torch.search import finetune as ft, search_budget  # noqa: E402
from repro_torch.search.simulator import evaluate_accuracy  # noqa: E402


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--budget", type=float, default=8 / 64)
    ap.add_argument("--plan-out", type=str, default=None,
                    help="save the searched Plan (JSON) here")
    ap.add_argument("--plan-in", type=str, default=None,
                    help="reuse a saved Plan instead of searching")
    ap.add_argument("--objective", choices=("bytes", "latency"), default="bytes",
                    help="what the search scores candidate configs by: "
                         "'bytes' (total wire bytes, the paper's proxy) or "
                         "'latency' (schedule-predicted fused-round latency "
                         "under --network — what the round-dominated serving "
                         "path actually pays; accuracy ties keep the "
                         "latency-minimal config)")
    ap.add_argument("--network", choices=("lan", "wan", "highbw"), default="wan",
                    help="network preset for --objective latency "
                         "(paper §5.2: WAN is where rounds dominate)")
    ap.add_argument("--device", default=None,
                    help="torch device (default the GPU; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    # --- setup: model + data -------------------------------------------------
    pipe = ImagePipeline(n_classes=10, hw=RESNET_SMOKE.in_hw)
    xs, ys = pipe.take(512, device=dev)
    params = resnet.init(RESNET_SMOKE, seed=0, device=dev)

    def afn(p, x, relu_fn=None):
        return resnet.apply(p, x, RESNET_SMOKE, relu_fn=relu_fn)

    print("[1/4] training the plaintext model...", flush=True)
    plan = api.trace_plan(afn, params,
                          (args.requests, 3, RESNET_SMOKE.in_hw, RESNET_SMOKE.in_hw),
                          name=RESNET_SMOKE.name)
    params, _ = ft.finetune(afn, params, xs[:384], ys[:384], plan.hb,
                            prng.PRNGKey(1, dev), epochs=4, batch=64, lr=3e-3)
    base_acc = evaluate_accuracy(afn, params, xs[384:], ys[384:], plan.hb,
                                 prng.PRNGKey(2, dev))
    print(f"      baseline accuracy: {base_acc:.3f}", flush=True)

    # --- offline phase: search (or reload a saved plan) + finetune -----------
    searched = None
    if args.plan_in:
        loaded = api.Plan.load(args.plan_in)
        if loaded.hb.n_groups != plan.hb.n_groups:
            raise SystemExit(
                f"--plan-in {args.plan_in}: saved plan has "
                f"{loaded.hb.n_groups} ReLU groups but this model traces "
                f"{plan.hb.n_groups} — it was searched for a different "
                "model/config")
        # adopt the saved (k, m) assignment (and adder mode) onto this
        # run's fresh trace so cost accounting matches the request batch
        plan = dataclasses.replace(
            plan.with_hb(api.HBConfig(loaded.hb.layers, plan.hb.group_elements)),
            cone=loaded.cone)
        print(f"[2/4] reusing saved plan {args.plan_in}: "
              f"{[(l.k, l.m) for l in plan.hb.layers]} "
              f"({plan.hb.budget_fraction():.3f} of bits)", flush=True)
    else:
        print(f"[2/4] HummingBird-b search (budget {args.budget:.3f}, "
              f"objective {args.objective})...", flush=True)
        res = search_budget(afn, params, xs[384:448], ys[384:448], plan,
                            prng.PRNGKey(3, dev), budget=args.budget,
                            bit_choices=(6, 8), objective=args.objective,
                            network=args.network)
        plan = res.plan
        unit = "B" if res.objective == "bytes" else "s"
        print(f"      found {[(l.k, l.m) for l in plan.hb.layers]} "
              f"({plan.hb.budget_fraction():.3f} of bits, "
              f"{res.objective}={res.objective_value:.4g}{unit}, "
              f"{res.search_time_s:.1f}s)", flush=True)
        searched = {"objective": res.objective, "objective_value": res.objective_value,
                    "search_time_s": res.search_time_s}
    if args.plan_out:
        plan.save(args.plan_out)
        print(f"      plan saved to {args.plan_out}", flush=True)
    params, _ = ft.finetune(afn, params, xs[:384], ys[:384], plan.hb,
                            prng.PRNGKey(4, dev), epochs=1, batch=64)

    # --- online phase: batched private inference -----------------------------
    print(f"[3/4] serving {args.requests} private requests (real GMW)...", flush=True)
    req_x, req_y = xs[448:448 + args.requests], ys[448:448 + args.requests]
    session = api.Session(key=7, device=dev)
    model = api.compile(afn, params, RESNET_SMOKE, plan, session)
    _sync(dev)
    t0 = time.perf_counter()
    X = model.encrypt(prng.PRNGKey(5, dev), req_x)
    out = model(X, key=prng.PRNGKey(6, dev))
    pred = out.reveal().argmax(-1)
    _sync(dev)
    wall = time.perf_counter() - t0
    acc = float((pred == req_y).float().mean())
    with torch.no_grad():
        plain_pred = afn(params, req_x).argmax(-1)
    agree = float((pred == plain_pred).float().mean())

    # --- report ----------------------------------------------------------------
    print("[4/4] results")
    r = costmodel.reduction_factors(plan.hb)
    print(f"      private-inference accuracy: {acc:.3f} "
          f"(plaintext agreement {agree:.3f})")
    print(f"      comm reduction vs CrypTen-64: {r['bytes_reduction']:.2f}x "
          f"bytes, {r['rounds_reduction']:.2f}x rounds, "
          f"{r['bits_discarded_frac'] * 100:.1f}% of DReLU bits discarded")
    sched = plan.schedule()
    cost = plan.cost()
    lan, wan = plan.estimate(network=api.LAN), plan.estimate(network=api.WAN)
    print(f"      plan schedule: {sched.n_rounds} fused rounds, "
          f"{cost.bytes_tx / 1e6:.1f} MB/party, "
          f"LAN {lan * 1e3:.1f} ms, WAN {wan:.2f} s")
    print(f"      wall time ({dev}, both parties): {wall:.1f}s", flush=True)
    res = {"device": str(dev), "requests": args.requests,
           "kms": [[l.k, l.m] for l in plan.hb.layers], "cone": plan.cone,
           "budget_fraction": plan.hb.budget_fraction(), "plan": plan.to_json(),
           "digest": plan.digest(),
           "search": searched, "baseline_accuracy": base_acc, "accuracy": acc,
           "plaintext_agreement": agree, **r,
           "rounds": sched.n_rounds, "bytes_tx": cost.bytes_tx,
           "lan_s": lan, "wan_s": wan, "wall_s": wall}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
