"""ResNet-18/50 (the paper's own workload, CIFAR-sized stem).
Max pooling replaced by stride/avg per the paper's MPC setup (SS2.3)."""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str
    block: str                    # basic | bottleneck
    stage_blocks: Tuple[int, ...]
    widths: Tuple[int, ...] = (64, 128, 256, 512)
    n_classes: int = 10
    in_hw: int = 32


RESNET18 = ResNetConfig("resnet18", "basic", (2, 2, 2, 2))
RESNET50 = ResNetConfig("resnet50", "bottleneck", (3, 4, 6, 3))

SMOKE = ResNetConfig("resnet-smoke", "basic", (1, 1), widths=(8, 16),
                     n_classes=10, in_hw=16)
