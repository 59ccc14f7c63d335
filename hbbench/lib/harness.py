"""One run of one cell: set-up, the measured window, (with ``trace``) a
profiled stretch, then the check against the plain reference and the
metrics, each read by its own reader from the run's record."""
from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import torch

from . import cell as cell_lib, rng, trace as trace_lib
from ..work import adder as adder_work, linear as linear_work

#: top-level module names that no run may have loaded once the window closed
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is banned, compared whole:
    ``repro_torch`` is not ``repro``."""
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def keep_for_check(cell, seed: int):
    """Which calls' logits the check compares (besides the window's last):
    every call, or with ``sample_calls`` n and ``sample_from`` m in the mix's
    ``check``, n of the calls 0 .. m - 1 drawn from the seed, so every seed
    keeps as many."""
    check = cell.workload["check"]
    if "sample_calls" not in check:
        return lambda i: True
    order = sorted(range(int(check["sample_from"])),
                   key=lambda i: rng.key(seed, "sample", i))
    chosen = set(order[:int(check["sample_calls"])])
    return chosen.__contains__


def reference_logits(cell, seed: int, calls: List[int],
                     device) -> Iterator[Tuple[int, torch.Tensor]]:
    """The plain reference's logits of calls ``calls``, one call at a time
    on ``device``: the weights and inputs made again from the seed, float32
    with TF32 off."""
    mod, ref = cell.model, cell.reference
    clients = int(cell.workload["clients"])
    weights = mod.make_weights(cell.cfg, seed, device)
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            for i in calls:
                xs = mod.make_inputs(cell.cfg, seed, i, clients, device)
                yield i, ref.forward(cell.cfg, weights, torch.cat(xs))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def request_errors(got: Dict[int, torch.Tensor],
                   reference: Iterable[Tuple[int, torch.Tensor]]) -> Dict:
    """Each request's logits (one image's, or one sequence's every token's)
    against the reference's.  A request's error is its largest logit gap
    over the root mean square of every reference logit compared in the run
    (one scale for all of a run's requests, so a request whose logits
    happen to be small is not judged on a finer scale).  ``errors``: per
    request, in call order; ``nonfinite``: requests with a logit that is
    not finite (their error is infinite)."""
    gaps, sq, n, bad = [], 0.0, 0, 0
    for i, want in reference:
        for g, w in zip(got[i].to(want.device).double(), want.double()):
            if torch.isfinite(g).all():
                gaps.append(float((g - w).abs().max()))
            else:
                gaps.append(math.inf)
                bad += 1
            sq += float(w.square().sum())
            n += w.numel()
    scale = math.sqrt(sq / n) if n else 1.0
    return {"errors": [g / scale for g in gaps], "nonfinite": bad}


def judge(errors: List[float], request_err: float) -> float:
    """``wrong_share``: the share of requests whose error exceeds the
    mix's ``request_err``.  The program truncates each share locally
    (SecureML), which is exact to an LSB but with probability about |x| /
    2^64 wraps one element by 2^32 in value; such a request's answer is
    wrong by design, and the share of them is what the limit bounds."""
    return sum(e > request_err for e in errors) / max(len(errors), 1)


def error_summary(errors: List[float], request_err: float) -> Dict:
    """Quantiles of the requests' errors, for the readings and the log."""
    e = sorted(errors)
    if not e:
        return {}
    pick = lambda q: e[min(len(e) - 1, int(q * len(e)))]   # noqa: E731
    return {"requests": len(e), "p50": pick(0.5), "p90": pick(0.9),
            "p99": pick(0.99), "max": e[-1],
            "over_limit": sum(x > request_err for x in e),
            "over_10x_limit": sum(x > 10 * request_err for x in e)}


def _work(cell) -> Dict:
    clients = int(cell.workload["clients"])
    ops, least = linear_work.call_work(cell.model.linear_shapes(cell.cfg, clients))
    return {"adder_least_s": adder_work.least_s(
                cell.model.relu_calls(cell.cfg, cell.plan, clients)),
            "linear_least_s": least, "int8_ops": ops}


def run(cell: cell_lib.Cell, seed: int, seconds: float, trace: bool,
        device="cuda", t_start: Optional[float] = None,
        frac_bits: Optional[int] = None) -> Dict:
    """Run ``cell`` once; returns the result object (without the device
    block) and the record the readers read, with the calls the check
    compared (``checked_calls``).  ``frac_bits`` (the control) shares the
    inputs at that many fractional bits in place of the program's 16."""
    from .program import Program

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    on_card = device.type == "cuda"
    workload = cell.workload
    split = {"imports_s": time.perf_counter() - t_start}
    prog = Program(cell, seed, device, frac_bits)
    split.update(prog.split)
    for k in range(int(workload.get("warm_calls", 1))):
        t0 = time.perf_counter()
        warm = prog.call(-1 - k)           # the cell's shapes; captures the replay
        if on_card:
            torch.cuda.synchronize()
        split[f"warm{k}_s"] = time.perf_counter() - t0
    check = workload["check"]
    prog.reserve(int(check.get("sample_calls", 0)), warm["logits"])
    gc.collect()
    gc.freeze()                  # the set-up's objects leave the collector's passes
    setup_s = time.perf_counter() - t_start
    win = cell.loop.window(prog, seconds, trace, keep_for_check(cell, seed))
    rec = {"clients": prog.clients, "setup_s": setup_s, "setup_split": split,
           "window": win,
           "pool_build_s": prog.pool_build_s, "pool_bytes": prog.pool_bytes,
           "replayed": prog.replayed(), "work": _work(cell)}
    if trace and on_card:
        rec["stretch"] = trace_lib.profile_stretch(
            prog, len(win["calls"]), int(workload.get("profile_calls", 10)))
    rec["peak_bytes"] = torch.cuda.max_memory_allocated() if on_card else 0
    sched = (prog.schedule.n_rounds, prog.schedule.bytes_tx)
    off = sum((c["rounds"], c["bytes"]) != sched for c in win["calls"])
    prog.close()
    del prog, warm
    gc.unfreeze()
    gc.collect()
    got = win.pop("kept")
    rec["checked_calls"] = sorted(got)
    req = request_errors(got, reference_logits(cell, seed, sorted(got), device))
    del got
    rec["errors"] = error_summary(req["errors"], check["request_err"])
    numbers = {"wrong_share": judge(req["errors"], check["request_err"]),
               "nonfinite": req["nonfinite"], "schedule_off": off}
    limits = {"wrong_share": check["wrong_share"], "nonfinite": 0, "schedule_off": 0}
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell_lib.metric_module(m["name"]).read(rec)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": win["requests"], "failed": req["nonfinite"],
              "metrics": metrics}
    if trace and "stretch" in rec:
        result["breakdown"] = trace_lib.breakdown(rec["stretch"])
    result["checks"] = checks
    return result, rec
