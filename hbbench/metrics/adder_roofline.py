"""adder_roofline (device trace): the least time of the call's GMW adders
at the H100's memory peak (``work/adder.py``: from each ReLU group's width
and elements, the same for the dense and the cone form) over the device
time of every adder kernel by name, in the profiled stretch.  Nothing
when no adder kernel ran."""
import re

from hbbench.work import adder


def read(rec):
    stretch = rec.get("stretch")
    if not stretch:
        return None
    pat = re.compile(adder.KERNEL_PATTERN)
    us = sum(d for name, _, d in stretch["ops"] if pat.search(name))
    if us <= 0:
        return None
    return 100.0 * rec["work"]["adder_least_s"] * stretch["calls"] / (us / 1e6)
