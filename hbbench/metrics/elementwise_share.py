"""elementwise_share (device trace): the share of the device time in the
profiled stretch spent in kernels that PyTorch's own operators launch
(``at::`` symbols), not in the port's CUDA sources, of all device-op
time."""

TORCH_SYMBOLS = ("at::", "at_cuda_detail")


def read(rec):
    stretch = rec.get("stretch")
    if not stretch:
        return None
    total = sum(d for _, _, d in stretch["ops"])
    if total <= 0:
        return None
    own = sum(d for n, _, d in stretch["ops"] if any(s in n for s in TORCH_SYMBOLS))
    return 100.0 * own / total
