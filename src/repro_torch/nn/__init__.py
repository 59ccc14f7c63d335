"""Neural-net pieces of the port: the plaintext model zoo's layers
(``common``, ``attention``, ``moe``, ``ssm``) and the reduced-ring
nonlinearity lowering (``approx``)."""
from . import approx, attention, common, moe, ssm

__all__ = ["approx", "attention", "common", "moe", "ssm"]
