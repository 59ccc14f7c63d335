"""peak_GB (device counter): ``torch.cuda.max_memory_allocated()`` over
set-up and window, in 1e9 bytes; nothing on a run without a card."""


def read(rec):
    return rec["peak_bytes"] / 1e9 if rec["peak_bytes"] else None
