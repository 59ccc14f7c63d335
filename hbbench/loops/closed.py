"""Closed loop: the workload's ``clients`` each wait for their reply, so
every call serves one fresh request from each client, as sibling streams
of one ``PrivateModel`` call.  The window runs calls until ``seconds``
have passed; it ends when the last call's replies are on the host, so a
rate is taken over all the work and all the time of the window."""
from __future__ import annotations

import time
from typing import Dict


def window(prog, seconds: float, spans: bool, keep) -> Dict:
    """Run the window.  ``keep(i)`` says whether call i's logits are kept
    for the check (revealed into a buffer of their own); the last call's
    are always kept, cloned once the window has closed."""
    calls, kept = [], {}
    last = None
    t0 = time.perf_counter()
    i = 0
    while True:
        rec = prog.call(i, spans=spans, keep=keep(i))
        rec["end_s"] = time.perf_counter() - t0
        logits = rec.pop("logits")
        if keep(i):
            kept[i] = logits
        last = (i, logits)
        calls.append(rec)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    t1 = time.perf_counter()
    if last[0] not in kept:
        kept[last[0]] = last[1].clone()
    return {"calls": calls, "seconds": t1 - t0, "kept": kept,
            "requests": prog.clients * len(calls)}
