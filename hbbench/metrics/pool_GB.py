"""pool_GB (program counter): the triple pool's ``device_bytes()``, in 1e9
bytes."""


def read(rec):
    return rec["pool_bytes"] / 1e9 if rec["pool_bytes"] else None
