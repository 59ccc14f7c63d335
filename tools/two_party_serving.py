#!/usr/bin/env python3
"""Full two-party deployment on the port: party processes + HTTP frontend,
end to end (the twin of ``examples/two_party_serving.py``: same flags, job
and request mix, plus ``--device``).

1. writes a smoke job directory (plan, seeds, per-party input share rows
   and triple slices);
2. launches party 1 as its OWN OS process in follower mode
   (``repro_torch.launch.party_host --follow``);
3. launches party 0 as a second process: the ``InferenceEngine`` leader
   behind the asyncio HTTP frontend (``repro_torch.serve.frontend``);
4. POSTs a mixed-tenant batch of requests to ``/infer``, polls
   ``/healthz`` / ``/stats``, and prints measured wall-clock latency
   next to the ``core.schedule`` prediction for the injected RTT.

    PYTHONPATH=src python tools/two_party_serving.py                # on the GPU
    PYTHONPATH=src python tools/two_party_serving.py --rtt-ms 4 --device cpu

``--make-job DIR`` only writes the job directory and exits.  Both party
processes get ``--device`` (their own default is the GPU).  Without
``--device`` it runs on the GPU, and raises where there is none.  A party
process that exits before the requests are answered, a reply other than
200, or a frontend that is not healthy within ``HEALTH_DEADLINE_S`` ends
the run with a non-zero exit.  The last output line is one JSON object
with the replies' rounds, the transport's counters and the leader's
kernel launches.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.configs import RESNET_SMOKE  # noqa: E402
from repro_torch.core import beaver, prng  # noqa: E402
from repro_torch.device import resolve  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from repro_torch.transport import free_port, write_job  # noqa: E402

HOST = "127.0.0.1"
HEALTH_DEADLINE_S = 300.0
MIX = (("alice", 10), ("bob", 11), ("alice", 12))


def make_job(job_dir, device=None) -> None:
    """Smoke job: traced plan + seeds + party-split shares and triples."""
    dev = resolve(device)
    params = resnet.init(RESNET_SMOKE, seed=0, device=dev)

    def afn(p, v, relu_fn=None):
        return resnet.apply(p, v, RESNET_SMOKE, relu_fn=relu_fn)

    plan = api.trace_plan(afn, params, (2, 3, 8, 8), name="smoke")
    plan = plan.with_hb(api.HBConfig(
        tuple([api.HBLayer(k=21, m=13)] * (plan.n_groups - 1)
              + [api.HBLayer(k=13, m=13)]), plan.group_elements))
    model = api.compile(afn, params, RESNET_SMOKE, plan, api.Session(key=0, device=dev))
    # the client's plaintext, drawn on the host (the same floats on every device)
    x = prng.normal(prng.PRNGKey(1, "cpu"), (2, 3, 8, 8)) * 0.5
    X = model.encrypt(prng.PRNGKey(2, dev), x)
    pool = beaver.gen_plan_triples(prng.PRNGKey(3, dev), plan.triple_specs())
    write_job(job_dir, plan=plan, config="smoke", params_seed=0,
              infer_key=4, session_seed=0, x=X, pool=pool)
    print(f"wrote job directory {job_dir}", flush=True)


def _http(method, url, body=None, timeout=600.0):
    """(status, JSON body); a reply other than 200 raises."""
    req = urllib.request.Request(
        url, method=method,
        data=json.dumps(body).encode() if body is not None else None)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, reply = resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        raise RuntimeError(f"{method} {url} answered {e.code}: "
                           f"{e.read().decode(errors='replace')[:2000]}") from e
    if status != 200:
        raise RuntimeError(f"{method} {url} answered {status}: {reply}")
    return status, reply


def _check_alive(children) -> None:
    """Every party process still running; else a SystemExit naming it."""
    for name, proc in children.items():
        rc = proc.poll()
        if rc is not None:
            raise SystemExit(f"two_party_serving: the {name} process (pid "
                             f"{proc.pid}) exited early with returncode {rc}")


def _wait_healthy(base, children, deadline_s=HEALTH_DEADLINE_S) -> dict:
    print(f"waiting up to {deadline_s:.0f} s for {base}/healthz (leader pid "
          f"{children['leader'].pid}, follower pid {children['follower'].pid})",
          flush=True)
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        _check_alive(children)
        try:
            _, health = _http("GET", f"{base}/healthz", timeout=5.0)
            if health.get("ok"):
                return health
        except (OSError, RuntimeError):
            pass
        time.sleep(0.25)
    raise TimeoutError(f"frontend at {base} not healthy within {deadline_s:.0f} s")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--make-job", default=None, metavar="DIR",
                    help="only write the job directory and exit")
    ap.add_argument("--job", default=None, help="reuse an existing job directory")
    ap.add_argument("--rtt-ms", type=float, default=0.0,
                    help="injected link RTT for both parties")
    ap.add_argument("--device", default=None,
                    help="torch device of this process and both parties "
                         "(default the GPU; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    if args.make_job:
        make_job(args.make_job, dev)
        return {"job": args.make_job}

    tmp = None
    if args.job is None:
        tmp = tempfile.TemporaryDirectory()
        args.job = os.path.join(tmp.name, "job")
        make_job(args.job, dev)

    link_port, http_port = free_port(), free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    shaping = ["--rtt-ms", str(args.rtt_ms)] if args.rtt_ms > 0 else []
    device = ["--device", str(dev)]
    children = {}
    base = f"http://{HOST}:{http_port}"
    try:
        children["follower"] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.party_host", "--party", "1",
             "--job", args.job, "--peer", f"{HOST}:{link_port}", "--follow"]
            + shaping + device, env=env, cwd=ROOT)
        children["leader"] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.serve.frontend", "--job", args.job,
             "--listen", f"{HOST}:{link_port}", "--http", f"{HOST}:{http_port}"]
            + shaping + device, env=env, cwd=ROOT)
        _wait_healthy(base, children)
        print(f"frontend healthy at {base}; POSTing mixed-tenant batch", flush=True)

        replies = []
        t0 = time.perf_counter()
        for tenant, seed in MIX:
            x = (prng.normal(prng.PRNGKey(seed, "cpu"), (2, 3, 8, 8)) * 0.5).numpy()
            _, resp = _http("POST", f"{base}/infer", {"tenant": tenant, "x": x.tolist()})
            y = np.asarray(resp["y"], np.float32)
            replies.append({"tenant": tenant, "argmax": np.argmax(y, -1).tolist(),
                            "y": y.tolist(), "wall_s": resp["wall_s"],
                            "measured_rounds": resp["batch"]["measured_rounds"],
                            "predicted_rounds": resp["batch"]["predicted_rounds"]})
            print(f"  {tenant}: argmax {replies[-1]['argmax']} "
                  f"({resp['wall_s']:.3f}s wall, "
                  f"{resp['batch']['measured_rounds']} rounds vs "
                  f"{resp['batch']['predicted_rounds']} predicted)", flush=True)
        wall = time.perf_counter() - t0

        _, stats = _http("GET", f"{base}/stats")
        _check_alive(children)
        tr = stats.get("transport", {})
        print(f"\n{len(MIX)} requests in {wall:.2f}s "
              f"({len(MIX) / wall:.2f} req/s) across {stats['batches']} "
              f"batches; transport: {tr.get('rounds')} rounds, "
              f"{tr.get('payload_bytes')} payload B, "
              f"{tr.get('retries')} retries")
        if args.rtt_ms > 0:
            print(f"injected RTT {args.rtt_ms}ms -> per-round floor "
                  f"{args.rtt_ms / 1e3:.4f}s x {tr.get('rounds')} rounds = "
                  f"{args.rtt_ms / 1e3 * (tr.get('rounds') or 0):.3f}s "
                  f"minimum comm wall")
        res = {"device": str(dev), "rtt_ms": args.rtt_ms, "requests": replies,
               "wall_s": wall, "batches": stats["batches"], "transport": tr,
               "leader_launches": stats.get("launches", {})}
        print(json.dumps(res), flush=True)
        return res
    finally:
        for proc in children.values():
            proc.terminate()
        for proc in children.values():
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        if tmp is not None:
            tmp.cleanup()


if __name__ == "__main__":
    main()
