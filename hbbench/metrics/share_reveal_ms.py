"""share_reveal_ms (harness spans, synchronized): per call, the secret
sharing of every client's input (``PrivateModel.encrypt``) plus the reveal
and decode of every output to the host (``MPCTensor.reveal``); the median
over the traced window's calls."""
import statistics


def read(rec):
    calls = rec["window"]["calls"]
    return 1e3 * statistics.median(c["encrypt_s"] + c["reveal_s"] for c in calls) \
        if calls else None
