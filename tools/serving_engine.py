#!/usr/bin/env python3
"""Request-level serving on the port: concurrent tenants share fused
protocol rounds (the twin of ``examples/serving_engine.py``: same flags,
mix and keys, plus ``--device``).

Three requests from two tenants — two identical shapes and one ragged —
are submitted to an ``InferenceEngine`` and served as ONE fused
micro-batch: every request advances through the GMW protocol in lockstep,
so the batch pays max-over-requests rounds instead of the sum, while each
request keeps its own PRNG stream (forked from its request id) and its
tenant's metered triple budget.

    PYTHONPATH=src python tools/serving_engine.py            # on the GPU
    PYTHONPATH=src python tools/serving_engine.py --device cpu --merge-identical

Without ``--device`` it runs on the GPU, and raises where there is none.
The last output line is one JSON object with the batch's report, each
tenant's usage, the Gantt chart and the revealed logits.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.configs import RESNET_SMOKE  # noqa: E402
from repro_torch.core import prng, schedule as schedule_lib  # noqa: E402
from repro_torch.device import resolve  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from repro_torch.serve import BatchPolicy, InferenceEngine  # noqa: E402

MIX = (("alice", (2, 3, 8, 8)), ("bob", (2, 3, 8, 8)), ("alice", (1, 3, 8, 8)))
TENANT_BUDGETS = {"bob": 200_000}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--network", default="lan", choices=["lan", "wan", "highbw"])
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--merge-identical", action="store_true",
                    help="opt into cross-request relu_many auto-batching")
    ap.add_argument("--device", default=None,
                    help="torch device (default the GPU; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    params = resnet.init(RESNET_SMOKE, seed=0, device=dev)

    def afn(p, v, relu_fn=None):
        return resnet.apply(p, v, RESNET_SMOKE, relu_fn=relu_fn)

    plan = api.trace_plan(afn, params, (2, 3, 8, 8), name=RESNET_SMOKE.name)
    plan = plan.with_hb(api.HBConfig(
        tuple([api.HBLayer(k=21, m=13)] * plan.n_groups), plan.group_elements))

    engine = InferenceEngine(
        afn, params, RESNET_SMOKE, plan, api.Session(key=0, device=dev),
        policy=BatchPolicy(network=args.network, max_batch=args.max_batch,
                           merge_identical=args.merge_identical),
        tenant_budgets=TENANT_BUDGETS)

    futures = []
    for i, (tenant, shape) in enumerate(MIX):
        # the client's plaintext, drawn on the host (the same floats on
        # every device)
        x = prng.normal(prng.PRNGKey(10 + i, "cpu"), shape) * 0.5
        futures.append(engine.submit(tenant, x))

    outs = [f.result().reveal_np() for f in futures]   # drains the queue
    for (tenant, shape), out in zip(MIX, outs):
        print(f"{tenant}: {shape} -> logits argmax "
              f"{np.argmax(out, -1).tolist()}")

    rep = engine.reports[0]
    print(f"\none fused micro-batch of {rep.n_requests} requests: "
          f"{rep.measured_rounds} rounds measured "
          f"(schedule predicted {rep.predicted_rounds}); serial execution "
          f"would pay {rep.serial_rounds} -> "
          f"{rep.rounds_saved_ratio:.1f}x rounds saved")
    usage = {tenant: engine.tenant_usage(tenant) for tenant in ("alice", "bob")}
    for tenant, u in usage.items():
        print(f"{tenant} triples: {u}")

    print("\nmerged-batch Gantt (first ReLU call of the batch):")
    plans = [engine.plan_for_shape(shape) for _, shape in MIX]
    specs = [p.call_specs()[:1] for p in plans]
    gantt = schedule_lib.simulate_merged(specs, auto_batch=False).gantt()
    print(gantt)
    res = {"device": str(dev), "network": args.network,
           "merge_identical": args.merge_identical,
           "batches": len(engine.reports), "n_requests": rep.n_requests,
           "measured_rounds": rep.measured_rounds,
           "predicted_rounds": rep.predicted_rounds,
           "measured_bytes": rep.measured_bytes, "predicted_bytes": rep.predicted_bytes,
           "serial_rounds": rep.serial_rounds,
           "rounds_saved_ratio": rep.rounds_saved_ratio, "tenant_usage": usage,
           "gantt": gantt, "plans": [p.to_json() for p in plans], "argmax": [np.argmax(o, -1).tolist() for o in outs],
           "logits": [o.tolist() for o in outs]}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
