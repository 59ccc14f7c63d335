"""linear_roofline (device trace): the least time of the call's ring
products (``work/linear.py``: 26 int8 plane products a multiply-add for a
public int32 weight, 36 secret by secret, at 1979 TOP/s, or their bytes at
3.35 TB/s, whichever is larger, per launch) over the device time of
``ring_matmul`` and ``ring_matmul_ss`` by name, in the profiled stretch.
Nothing when neither ran."""
import re

from hbbench.work import linear


def read(rec):
    stretch = rec.get("stretch")
    if not stretch:
        return None
    pat = re.compile(linear.KERNEL_PATTERN)
    us = sum(d for name, _, d in stretch["ops"] if pat.search(name))
    if us <= 0:
        return None
    return 100.0 * rec["work"]["linear_least_s"] * stretch["calls"] / (us / 1e6)
