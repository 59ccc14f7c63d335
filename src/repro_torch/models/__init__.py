"""Model zoo of the port: ResNet, the decoder LM (every family) and the
encoder-decoder."""
from . import encdec, lm, resnet

__all__ = ["encdec", "lm", "resnet"]
