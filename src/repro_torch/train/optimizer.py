"""The learning-rate schedule, global-norm clipping and SGD with momentum
over a params tree (twin of part of the reference's
``train/optimizer.py``: what the search's finetune uses; ``AdamW`` and
``Adafactor`` are not ported yet).

A params tree is nested dicts and lists of tensors, as the models'
``init`` returns; an update returns new trees and leaves its inputs as
they were.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List

import torch


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Linear warmup + cosine decay (decay_steps=0 for constant)."""

    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_ratio: float = 0.1

    def __call__(self, step) -> float:
        step = float(step)
        warm = min(1.0, (step + 1) / max(self.warmup_steps, 1))
        if not self.decay_steps:
            return self.peak_lr * warm
        frac = min(max((step - self.warmup_steps)
                       / max(self.decay_steps - self.warmup_steps, 1), 0.0), 1.0)
        cos = 0.5 * (1 + math.cos(math.pi * frac))
        return self.peak_lr * warm * (self.min_ratio + (1 - self.min_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


@dataclasses.dataclass(frozen=True)
class SGD:
    schedule: Schedule = Schedule()
    momentum: float = 0.9
    weight_decay: float = 0.0

    def init(self, params):
        return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                              params)}

    def update(self, grads, state, params, step):
        """(new params, new state, {"lr": lr}) after one step at ``step``."""
        lr = self.schedule(step)
        m2 = tree_map(lambda g, m, p: self.momentum * m
                      + (g.to(torch.float32) + self.weight_decay * p),
                      grads, state["m"], params)
        return tree_map(lambda p, m: p - lr * m, params, m2), {"m": m2}, {"lr": lr}
