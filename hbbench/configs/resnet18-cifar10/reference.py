"""Plain PyTorch forward of ResNet-18 as ``config.json`` states it, in
float32: conv, BatchNorm from its statistics (not folded), exact ReLU,
strided downsampling with 1x1 projections, global average pooling, fc.
It imports nothing of the program and takes only the weights and images
the benchmark made."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _bn(x, p, eps: float):
    inv = p["gamma"] / torch.sqrt(p["var"] + eps)
    return (x - p["mean"][:, None, None]) * inv[:, None, None] + p["beta"][:, None, None]


def forward(cfg, weights, x: torch.Tensor, block_rows: int = 256,
            relu=None) -> torch.Tensor:
    """Logits (B, classes) of images x (B, C, H, W), ``block_rows`` images
    at a time.  ``relu(v, group)``, when given, is called in place of
    every ReLU (group 0 the stem, then one per stage)."""
    eps = cfg["bn_eps"]
    relu = relu or (lambda v, g: F.relu(v))
    outs = []
    for xb in x.split(block_rows):
        h = relu(_bn(F.conv2d(xb, weights["stem"], padding=1), weights["bn_stem"], eps), 0)
        for si, stage in enumerate(weights["stages"]):
            for bi, blk in enumerate(stage):
                stride = 2 if (bi == 0 and si > 0) else 1
                y = relu(_bn(F.conv2d(h, blk["conv1"], stride=stride, padding=1),
                             blk["bn1"], eps), si + 1)
                y = _bn(F.conv2d(y, blk["conv2"], padding=1), blk["bn2"], eps)
                if "proj" in blk:
                    h = _bn(F.conv2d(h, blk["proj"], stride=stride), blk["bn_proj"], eps)
                h = relu(h + y, si + 1)
        outs.append(h.mean(dim=(2, 3)) @ weights["fc"]["w"] + weights["fc"]["b"])
    return torch.cat(outs)
