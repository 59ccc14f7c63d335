"""mfu_int8 (host clock and the frozen work count): every ring product's
int8 plane products in the traced window's calls, both parties, counted as
for ``linear_roofline``, over the window's time at 1979 TOP/s.  It bounds
a gain after a later change takes a kernel off the path."""
from hbbench.work import peaks


def read(rec):
    win = rec["window"]
    if not win["calls"] or win["seconds"] <= 0 or not rec.get("stretch"):
        return None
    ops = rec["work"]["int8_ops"] * len(win["calls"])
    return 100.0 * ops / (win["seconds"] * peaks.INT8_OPS_PER_S)
