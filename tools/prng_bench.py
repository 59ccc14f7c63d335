#!/usr/bin/env python3
"""Time the port's Threefry draws on the GPU: ``prng.bits_words`` at a few
sizes (one hash per word; past ``prng.BITS_CHUNK["cuda"]`` words in chunks)
and ``beaver.gen_plan_triples`` of full-width ResNet-18's exact plan at
batch 1 (the offline triple pool, whose time is mostly draws).

    python3 tools/prng_bench.py [--src DIR] [--trials 5]

``--src`` is the ``src`` directory to import ``repro_torch`` from (default
this checkout's), so that two versions are timed in one session: run the
script once per version, in the order A, B, B, A.  Each figure is the
median over ``--trials`` of CUDA-event times, after one warm-up.  Prints
the card's name and power limit, then one JSON line.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (1 << 20, 1 << 24, 1 << 26)


def _median_ms(torch, fn, trials: int) -> float:
    fn()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--trials", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    from repro_torch.configs import RESNET18
    from repro_torch.core import beaver, prng
    from repro_torch.models import resnet

    if not torch.cuda.is_available():
        raise SystemExit("prng_bench: no GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    key = prng.PRNGKey(0, "cuda")
    res = {"src": os.path.abspath(args.src), "gpu": smi, "bits_words_ms": {}}
    for n in SIZES:
        res["bits_words_ms"][n] = _median_ms(
            torch, lambda n=n: prng.bits_words(key, (n,)), args.trials)
    plan = resnet.trace(resnet.init(RESNET18, seed=0, device="meta"), RESNET18, batch=1)
    specs = plan.triple_specs()
    res["triple_words"] = sum(n * w for n, w in specs)
    res["gen_plan_triples_ms"] = _median_ms(
        torch, lambda: beaver.gen_plan_triples(key, specs), args.trials)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
