"""Optimizers written out over params trees, no ``torch.optim`` (twin of
the reference's ``train/optimizer.py``): the learning-rate schedule,
global-norm clipping, ``AdamW``, ``Adafactor`` and ``SGD``.

A params tree is nested dicts and lists of tensors, as the models'
``init`` returns; an update returns new trees and leaves its inputs as
they were.  Each update is the reference's arithmetic in its order:
AdamW clips, then bias-corrects both moments and adds the decoupled
weight decay inside the step; Adafactor keeps factored row/col second
moments for every leaf of two or more dims and clips the update's RMS.
States mirror the params tree (Adafactor's leaves are ``{"row", "col"}``
or ``{"v"}`` dicts), so the checkpoint store walks them as the
reference's pytrees.  ``step`` is an int or a 0-d tensor.  The schedule
and the bias corrections are float32 tensor ops on the step tensor's
device (the CPU for an int), in the reference's order: nothing is read
back to the host, so a step runs under ``FakeTensorMode`` and never waits
on the card.
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

    def __call__(self, step) -> torch.Tensor:
        """The learning rate at ``step``, a float32 0-d tensor."""
        step = _step_f32(step)
        warm = torch.clamp((step + 1) / max(self.warmup_steps, 1), max=1.0)
        if not self.decay_steps:
            return self.peak_lr * warm
        frac = torch.clamp((step - self.warmup_steps)
                           / max(self.decay_steps - self.warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return self.peak_lr * warm * (self.min_ratio + (1 - self.min_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def _step_f32(step) -> torch.Tensor:
    """``step`` (an int or a 0-d tensor) as a float32 0-d tensor on its
    device, read by no host."""
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def _pow_f32(base: float, t: torch.Tensor) -> torch.Tensor:
    """``base ** t`` in float32, as jnp raises a weak float to a float32."""
    return torch.full((), base, dtype=torch.float32, device=t.device) ** t


@dataclasses.dataclass(frozen=True)
class AdamW:
    schedule: Schedule = Schedule()
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(self, grads, state, params, step):
        """(new params, new state, {"lr", "gnorm"}) after one step at ``step``."""
        grads, gnorm = clip_by_global_norm(grads, self.clip_norm)
        lr = self.schedule(step)
        t = _step_f32(step) + 1.0
        bc1 = 1 - _pow_f32(self.b1, t)
        bc2 = 1 - _pow_f32(self.b2, t)

        m2 = tree_map(lambda g, m: self.b1 * m + (1 - self.b1) * g.to(torch.float32),
                      grads, state["m"])
        v2 = tree_map(lambda g, v: self.b2 * v + (1 - self.b2) * g.to(torch.float32)
                      * g.to(torch.float32), grads, state["v"])
        new_p = tree_map(lambda p, m, v: p - lr * (
            (m / bc1) / (torch.sqrt(v / bc2) + self.eps) + self.weight_decay * p),
            params, m2, v2)
        return new_p, {"m": m2, "v": v2}, {"lr": lr, "gnorm": gnorm}


@dataclasses.dataclass(frozen=True)
class Adafactor:
    """Factored second moments: O(n+m) state for an (n, m) matrix."""

    schedule: Schedule = Schedule()
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0

    def init(self, params):
        def zeros(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)
            if p.ndim >= 2:
                return {"row": z(p.shape[:-1]), "col": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}

        return {"f": tree_map(zeros, params)}

    def update(self, grads, state, params, step):
        """(new params, new state, {"lr"}) after one step at ``step``."""
        lr = self.schedule(step)
        t = _step_f32(step) + 1.0
        beta = 1.0 - t ** (-self.decay)

        def factors(g, f):
            g = g.to(torch.float32)
            g2 = g * g + self.eps
            if g.ndim >= 2:
                return {"row": beta * f["row"] + (1 - beta) * g2.mean(dim=-1),
                        "col": beta * f["col"] + (1 - beta) * g2.mean(dim=-2)}
            return {"v": beta * f["v"] + (1 - beta) * g2}

        def upd(g, f, p):
            if "v" in f:
                vhat = f["v"]
            else:
                row = f["row"]
                vhat = row[..., None] / torch.clamp_min(
                    row.mean(dim=-1, keepdim=True)[..., None], self.eps) * f["col"][..., None, :]
            g = g.to(torch.float32)
            u = g / torch.sqrt(torch.clamp_min(vhat, self.eps))
            rms = torch.sqrt(torch.mean(u * u) + self.eps)
            return p - lr * (u / torch.clamp_min(rms / self.clip_threshold, 1.0))

        new_f = tree_map(factors, grads, state["f"])
        return tree_map(upd, grads, new_f, params), {"f": new_f}, {"lr": lr}


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


def get(name: str, **kwargs):
    return {"adamw": AdamW, "adafactor": Adafactor, "sgd": SGD}[name](**kwargs)
