"""wire_MB_per_request (program counter): ``CoalescingComm`` bytes one
party sends in one direction per call, over the call's requests, in 1e6
bytes; the mean over the window's calls."""


def read(rec):
    calls = rec["window"]["calls"]
    if not calls:
        return None
    return sum(c["bytes"] for c in calls) / len(calls) / rec["clients"] / 1e6
