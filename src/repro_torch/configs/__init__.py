"""Model configs of the port: ResNet, and the LM architectures (copies of
the reference's ``configs/``, plain dataclasses with no jax)."""
from .base import SHAPES, ArchConfig, ShapeConfig, shape_applicable, smoke_variant
from .registry import ARCHS, all_names, get
from .resnet import RESNET18, RESNET50, SMOKE as RESNET_SMOKE, ResNetConfig

__all__ = ["SHAPES", "ArchConfig", "ShapeConfig", "shape_applicable",
           "smoke_variant", "ARCHS", "all_names", "get", "RESNET18",
           "RESNET50", "RESNET_SMOKE", "ResNetConfig"]
