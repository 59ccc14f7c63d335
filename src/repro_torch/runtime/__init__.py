"""Round-loop backend selection (twin of the reference's ``repro.runtime``)."""
from .loop import compiled_eligible, round_loop_mode

__all__ = ["compiled_eligible", "round_loop_mode"]
