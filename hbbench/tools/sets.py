"""Measure a cell as the bounds are set: two sets of runs on the same
seeds, each run a process of its own (the benchmark's command) beside the
host's speed (a fixed pure-Python loop timed before it), then the traced
runs.  Prints every
result line and, per metric and set, the median and the spread (the
distance between the first and third quartiles of
``statistics.quantiles(values, n=4)``, as a share of the median); then, per
metric, the mean of the sets' spreads without each set's run farthest from
its median, and the spread of all runs together.

    python hbbench/tools/sets.py --workload <cell> --seeds S1 .. S6 --traced T1 T2 T3 [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
#: a fixed pure-Python loop: the seconds a fresh interpreter takes for it
#: measure the host's speed beside each run
PROBE = "import time\nt=time.perf_counter()\ns=0\nfor i in range(10_000_000): s+=i&7\nprint(time.perf_counter()-t)"


def probe_s() -> float:
    return float(subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                                text=True).stdout)


def run(workload: str, seed: int, seconds: int, trace: int, out: pathlib.Path):
    cmd = [sys.executable, "hbbench/run.py", "--workload", workload, "--seed",
           str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    probe = probe_s()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    tag = f"{workload}_{seed}_{trace}"
    (out / f"{tag}.err").write_text(p.stderr)
    line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
    (out / f"{tag}.out").write_text(line + "\n")
    note = [l for l in p.stderr.splitlines() if l.startswith(("hbbench:", "check "))]
    print(f"{tag} rc={p.returncode} host probe {probe:.3f} s | " + " | ".join(note),
          flush=True)
    return json.loads(line) if p.returncode == 0 and line else None


def spread(values):
    q1, med, q3 = statistics.quantiles(values, n=4)
    return statistics.median(values), (q3 - q1) / statistics.median(values)


def _drop_farthest(values):
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--traced", type=int, nargs="*", default=[])
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--out", default="build/hbbench_sets")
    args = ap.parse_args()
    out = ROOT / args.out
    out.mkdir(parents=True, exist_ok=True)
    seconds = json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    sets = []
    for k in range(args.sets):
        sets.append([run(args.workload, s, seconds, 0, out) for s in args.seeds])
    for s in args.traced:
        r = run(args.workload, s, seconds, 1, out)
        if r:
            print(json.dumps({"traced": s, "metrics": r["metrics"], "device": r["device"],
                              "breakdown": r.get("breakdown"), "checks": r["checks"]}))
    for k, results in enumerate(sets):
        ok = [r for r in results if r]
        print(f"set {k}: {len(ok)} of {len(results)} runs, correct "
              f"{sum(r['correct'] for r in ok)}")
        for name in sorted({m for r in ok for m in r["metrics"]}):
            vals = [r["metrics"][name]["value"] for r in ok if name in r["metrics"]]
            if len(vals) >= 2:
                med, sp = spread(vals)
                print(f"  {name}: median {med!r} spread {sp!r} values {vals}")
    names = sorted({m for results in sets for r in results if r for m in r["metrics"]})
    for name in names:
        per_set = [[r["metrics"][name]["value"] for r in results
                    if r and name in r["metrics"]] for results in sets]
        if min(map(len, per_set)) < 4:
            continue
        tight = statistics.mean(spread(_drop_farthest(v))[1] for v in per_set)
        wide = spread([x for v in per_set for x in v])[1]
        meds = [statistics.median(v) for v in per_set]
        print(f"{name}: spread without each set's farthest run {tight!r} (a bound "
              f"under twice it is too tight); all runs {wide!r} (a bound over eight "
              f"times it is too loose); set medians {meds}")


if __name__ == "__main__":
    main()
