"""Neural-net pieces of the port: the dense LM's building blocks
(``common``, ``attention``) and the reduced-ring nonlinearity lowering
(``approx``)."""
from . import approx, attention, common

__all__ = ["approx", "attention", "common"]
