"""Training pieces of the port (twin of part of the reference's
``repro.train``): the optimizer that the search's finetune uses."""
from . import optimizer

__all__ = ["optimizer"]
