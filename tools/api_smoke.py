#!/usr/bin/env python3
"""The port's api end to end in seconds: trace -> plan -> session ->
compile -> call -> serve_step (the twin of ``examples/api_smoke.py``: same
steps and keys, plus ``--device``).

    PYTHONPATH=src python tools/api_smoke.py                 # on the GPU
    PYTHONPATH=src python tools/api_smoke.py --device cpu

Without ``--device`` it runs on the GPU, and raises where there is none.
The last output line is one JSON object with the plan's figures, its JSON
digest, the argmaxes and the revealed logits of the call and of the
served step.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.configs import RESNET_SMOKE  # noqa: E402
from repro_torch.core import beaver, fixed, prng, ring, shares  # noqa: E402
from repro_torch.core.hummingbird import HBConfig, HBLayer  # noqa: E402
from repro_torch.device import resolve  # noqa: E402
from repro_torch.models import resnet  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default the GPU; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    params = resnet.init(RESNET_SMOKE, seed=0, device=dev)
    # the client's plaintext is drawn on the host, so that every device
    # shares the same floats (torch's erfinv differs by ulps between them)
    x = (prng.normal(prng.PRNGKey(1, "cpu"), (2, 3, 8, 8)) * 0.5).to(dev)

    def afn(p, v, relu_fn=None):
        return resnet.apply(p, v, RESNET_SMOKE, relu_fn=relu_fn)

    # offline: trace a plan, assign (k, m) per group (last group culled)
    plan = api.trace_plan(afn, params, tuple(x.shape), name="smoke")
    plan = plan.with_hb(HBConfig(tuple([HBLayer(k=21, m=13)] * (plan.n_groups - 1)
                                       + [HBLayer(k=13, m=13)]), plan.group_elements))
    cost = plan.cost()
    lan_ms = plan.estimate(network=api.LAN) * 1e3
    line = (f"plan: {len(plan.calls)} ReLU calls, {plan.n_groups} groups, "
            f"{cost.bytes_tx} B/party, {cost.rounds} rounds, "
            f"LAN estimate {lan_ms:.2f} ms")
    print(line)

    # JSON round-trip is exact
    assert api.Plan.from_json(plan.to_json()) == plan

    # online: compile and run private inference
    model = api.compile(afn, params, RESNET_SMOKE, plan, api.Session(key=0, device=dev))
    X = model.encrypt(prng.PRNGKey(2, dev), x)
    out = model(X)
    # the plaintext forward of the plan: a culled group's ReLU is the
    # identity there too (the seeded weights here are not the reference's,
    # and with them the exact-ReLU argmax is not the culled model's)
    with torch.no_grad():
        exact = np.argmax(afn(params, x).cpu().numpy(), -1)
        want = np.argmax(afn(params, x, relu_fn=lambda v, g: (
            v if plan.hb.layers[g].is_identity else torch.relu(v))).cpu().numpy(), -1)
    logits = out.reveal_np()
    got = np.argmax(logits, -1)
    assert (got == want).all(), (got, want)
    print("private __call__ matches plaintext argmax:", got.tolist())

    # serving: same replay as a step with an offline triple pool
    pool = beaver.gen_plan_triples(prng.PRNGKey(3, dev), plan.triple_specs())
    step = model.serve_step()
    y = step(params, X.data, pool, prng.PRNGKey(4, dev))
    served = fixed.decode_np(shares.reconstruct(y))
    assert (np.argmax(served, -1) == want).all()
    print("serve_step (offline TriplePool) matches: OK")
    res = {"device": str(dev), "plan_line": line, "calls": len(plan.calls),
           "groups": plan.n_groups, "bytes_tx": cost.bytes_tx, "rounds": cost.rounds,
           "lan_ms": lan_ms, "plan": plan.to_json(), "digest": plan.digest(),
           "argmax": got.tolist(),
           "exact_relu_argmax": exact.tolist(),
           "logits": logits.tolist(), "served": served.tolist(),
           "call_shares": ring.to_uint64_np(out.data).tolist(),
           "served_shares": ring.to_uint64_np(y).tolist()}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
