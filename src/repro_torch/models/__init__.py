"""Model zoo of the port: ResNet and the dense decoder LM."""
from . import lm, resnet

__all__ = ["lm", "resnet"]
