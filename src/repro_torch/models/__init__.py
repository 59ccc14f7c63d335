"""Model zoo of the port: ResNet."""
from . import resnet

__all__ = ["resnet"]
