"""A steady stretch of many calls under ``torch.profiler``, reduced to what
the per-layer readers take: every device op (kernel, memcpy, memset) with
its time, the stretch's span, the union of device intervals in it, and the
idle gaps between them labelled by what the host was doing."""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import Dict, List, Tuple

import torch

STRETCH = "hbbench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_NAME = 120                      # longest op name kept in a breakdown
_LABELLED = 400                  # longest idle gaps given a host label
_LOOKBACK = 256                  # host operators searched back for the innermost


def profile_stretch(prog, first: int, n: int) -> Dict:
    """Calls ``first .. first + n`` under the profiler, one synchronize
    at the end; returns the reduced trace and the stretch's host wall."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(STRETCH):
            for i in range(first, first + n):
                prog.call(i, annotate=True)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    out = reduce_events(events)
    out.update(calls=n, wall_s=wall)
    return out


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce_events(events: List[Dict]) -> Dict:
    """The stretch's device ops ``[(name, start_us, dur_us)]``, its span
    (the ``STRETCH`` range), busy microseconds (the union of device
    intervals inside the span) and its ``_LABELLED`` longest idle gaps
    ``[(label, us)]``, each labelled by the outermost harness range and the
    innermost host operator open at its middle."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == STRETCH]
    if not spans:
        return {"ops": [], "span_us": 0.0, "busy_us": 0.0, "gaps": []}
    a0 = float(spans[0]["ts"])
    a1 = a0 + float(spans[0].get("dur", 0))
    ops = [(str(e.get("name")), float(e["ts"]), float(e.get("dur", 0)))
           for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and a0 <= float(e["ts"]) <= a1]
    busy = _merge([(max(s, a0), min(s + d, a1)) for _, s, d in ops])
    busy_us = sum(b - a for a, b in busy)
    edges = [a0] + [x for iv in busy for x in iv] + [a1]
    gaps = sorted(((edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
                   if edges[k + 1] > edges[k]), key=lambda g: g[0] - g[1])
    ann = [(str(e.get("name")), float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
           for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and e.get("name") != STRETCH]
    cpu = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                  str(e.get("name")))
                 for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op")
    starts = [c[0] for c in cpu]
    labelled = []
    for g0, g1 in gaps[:_LABELLED]:
        mid = (g0 + g1) / 2
        outer = [h for h in ann if h[1] <= mid <= h[2]]
        label = min(outer, key=lambda h: h[1])[0] if outer else "(between calls)"
        k = bisect.bisect_right(starts, mid)
        inner = next((c[2] for c in reversed(cpu[max(0, k - _LOOKBACK):k])
                      if c[1] >= mid), None)
        if inner:
            label += " > " + inner
        labelled.append((label[:_NAME], g1 - g0))
    gaps = labelled
    gaps.sort(key=lambda g: -g[1])
    return {"ops": ops, "span_us": a1 - a0, "busy_us": busy_us, "gaps": gaps}


def breakdown(stretch: Dict, top: int = 10) -> Dict:
    """The device ops that took most time, and the longest idle gaps
    grouped by label, each in seconds."""
    by_name: Dict[str, float] = {}
    for name, _, dur in stretch["ops"]:
        by_name[name[:_NAME]] = by_name.get(name[:_NAME], 0.0) + dur
    gaps: Dict[str, float] = {}
    for label, us in stretch["gaps"]:
        gaps[label] = gaps.get(label, 0.0) + us
    return {"device_ops": [[n, us / 1e6] for n, us in
                           sorted(by_name.items(), key=lambda r: -r[1])[:top]],
            "idle_gaps": [[n, us / 1e6] for n, us in
                          sorted(gaps.items(), key=lambda r: -r[1])[:top]]}
