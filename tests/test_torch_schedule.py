"""The port's copy of ``core/schedule.py`` against the reference: cone sets,
per-stream timelines and fused schedules over every ring width w = 1..64,
on seeded random stream mixes."""
import numpy as np
import pytest

from repro.core import schedule as jsched
from repro_torch.core import schedule as tsched


def _fields(s):
    return (s.n_rounds, s.bytes_tx, s.round_parts, s.round_bytes, s.groups,
            tuple(slot.phase_bytes for slot in s.slots), s.phase_bytes())


@pytest.mark.parametrize("cone", [False, True])
def test_schedule_sweep_matches_reference(cone):
    """For each w: the cone sets and one stream's timeline, then a random
    mix of 1-4 streams around w (duplicates auto-batch, zero elements and
    width 0 drop out) simulated with and without auto-batching, as one
    call, as a merged two-request batch, and framed."""
    rng = np.random.default_rng(13 + cone)
    for w in range(1, 65):
        assert tsched.n_levels(w) == jsched.n_levels(w)
        assert tsched.cone_sets(w) == jsched.cone_sets(w)
        n = int(rng.integers(1, 5000))
        assert tsched.stream_timeline(n, w, cone=cone) == \
            jsched.stream_timeline(n, w, cone=cone)
        assert tsched.stream_rounds(w, cone) == jsched.stream_rounds(w, cone)
        specs = []
        for _ in range(int(rng.integers(1, 5))):
            width = int(rng.choice([w, w, 0, int(rng.integers(1, 65))]))
            n_el = int(rng.choice([0, 32, 100, n]))
            specs.append((n_el, width, (n_el, width)))
        for auto_batch in (True, False):
            want = jsched.simulate(specs, cone=cone, auto_batch=auto_batch)
            got = tsched.simulate(specs, cone=cone, auto_batch=auto_batch)
            assert _fields(got) == _fields(want)
            assert _fields(got.framed()) == _fields(want.framed())
        requests = [specs, specs[::-1][:2]]
        assert _fields(tsched.simulate_merged(requests, cone=cone)) == \
            _fields(jsched.simulate_merged(requests, cone=cone))
