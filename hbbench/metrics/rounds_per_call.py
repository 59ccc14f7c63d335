"""rounds_per_call (program counter): ``CoalescingComm.n_rounds`` added by
one call, the median over the window's calls."""
import statistics


def read(rec):
    calls = rec["window"]["calls"]
    return float(statistics.median(c["rounds"] for c in calls)) if calls else None
