"""device_idle_share (device trace): one minus the union of the device's
kernel, memcpy and memset intervals over the span of the profiled stretch
of many calls."""


def read(rec):
    stretch = rec.get("stretch")
    if not stretch or stretch["span_us"] <= 0 or stretch["busy_us"] <= 0:
        return None
    return 100.0 * (1.0 - stretch["busy_us"] / stretch["span_us"])
