"""setup_s (host clock): from the start of the process's harness to the
window: imports, kernel build (first run in a checkout), weights, the plan,
the triple pool, and the warm-up calls that capture the replay."""


def read(rec):
    return rec["setup_s"]
