"""Training (twin of the reference's ``repro.train``): the optimizers and
the fault-tolerant loop."""
from . import loop, optimizer

__all__ = ["loop", "optimizer"]
