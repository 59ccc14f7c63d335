"""Round-loop backend selection, straggler detection, the H100 roofline and
the op analyzer (twin of the reference's ``repro.runtime``)."""
from .loop import compiled_eligible, round_loop_mode
from .watchdog import StragglerWatchdog

__all__ = ["compiled_eligible", "round_loop_mode", "StragglerWatchdog"]
