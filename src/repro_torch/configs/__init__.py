"""Model configs of the port."""
from .resnet import RESNET18, RESNET50, SMOKE as RESNET_SMOKE, ResNetConfig

__all__ = ["RESNET18", "RESNET50", "RESNET_SMOKE", "ResNetConfig"]
