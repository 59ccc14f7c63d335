"""requests_per_s (host clock): every request completed in the window over
the window's time, which ends when the last call's replies are on the
host.  A request is one client's input."""


def read(rec):
    win = rec["window"]
    return win["requests"] / win["seconds"] if win["seconds"] > 0 else None
