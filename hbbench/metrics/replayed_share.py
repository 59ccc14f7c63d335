"""replayed_share (program counter): the share of the window's calls served
by the captured CUDA-graph replay.  A call is replayed when its stream
signature has a replay (``PrivateModel.replay_stats``) and the kernel
wrappers' launch counters (``kernels.ops.launch_counts``), which a replay
does not tick, did not move during it."""


def read(rec):
    calls = rec["window"]["calls"]
    if not calls:
        return None
    return 100.0 * sum(rec["replayed"] and c["launches"] == 0 for c in calls) / len(calls)
