"""§4.1.3 finetuning: a few epochs with the approximate ReLU in the loop
(twin of the reference's ``search/finetune.py``).

The reduced-ring sign estimate is piecewise constant in x, so the
gradient goes straight through: the forward uses the simulated
HummingBird ReLU, the backward the exact ReLU's gradient.  A training
step is functional over the params tree: every leaf, BatchNorm's ``mean``
and ``var`` included, is differentiated and updated, as the reference's
``value_and_grad`` over the whole tree does.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ..core import prng
from ..core.hummingbird import HBConfig
from ..train import optimizer as opt_lib
from . import simulator


def ste_hb_relu(x, k: int, m: int, key):
    """Forward: the approximate ReLU; backward: the exact ReLU's gradient."""
    approx = simulator.simulated_hb_relu(x, k, m, key)
    exact = F.relu(x)
    return exact + (approx - exact).detach()


def make_ste_relu(cfg: HBConfig, key) -> Callable:
    keys = prng.split(key, max(cfg.n_groups, 1))

    def relu_fn(x, g):
        layer = cfg.layers[g]
        if layer.k >= 64 and layer.m == 0:
            return F.relu(x)
        return ste_hb_relu(x, layer.k, layer.m, keys[g])

    return relu_fn


def loss_fn(apply_fn, params, xb, yb, hb_cfg: HBConfig, rkey) -> torch.Tensor:
    """Mean cross-entropy of the model with the STE ReLU."""
    logits = apply_fn(params, xb, relu_fn=make_ste_relu(hb_cfg, rkey))
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, 1, yb[:, None].to(torch.int64)).mean()


def train_step(apply_fn, opt, hb_cfg: HBConfig, params, opt_state, step: int,
               xb, yb, rkey):
    """(params, opt_state, step + 1, loss): one SGD step on the gradient of
    ``loss_fn`` with respect to every leaf of ``params``."""
    leaves = [t.detach().requires_grad_(True) for t in opt_lib.tree_leaves(params)]
    it = iter(leaves)
    tracked = opt_lib.tree_map(lambda _: next(it), params)
    loss = loss_fn(apply_fn, tracked, xb, yb, hb_cfg, rkey)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(t)
              for g, t in zip(grads, leaves))
    grads = opt_lib.tree_map(lambda _: next(it), params)
    with torch.no_grad():
        new_params, new_state, _ = opt.update(grads, opt_state, params, step)
    return new_params, new_state, step + 1, loss.detach()


@simulator.deterministic()
def finetune(apply_fn, params, xs, ys, hb_cfg: HBConfig, key, *,
             epochs: int = 2, batch: int = 64, lr: float = 1e-3):
    """A few epochs of cross-entropy finetuning with the approximate ReLU:
    SGD (momentum 0.9, constant ``lr``), batches in a fresh
    ``prng.permutation`` order each epoch.  Returns (params, losses).  Runs
    under ``simulator.deterministic()``, so the card gives the same params
    from the same seed on every run (the reference's XLA steps are
    deterministic too)."""
    opt = opt_lib.SGD(schedule=opt_lib.Schedule(peak_lr=lr, warmup_steps=0,
                                                decay_steps=0), momentum=0.9)
    opt_state = opt.init(params)
    step = 0
    relu_key, key = prng.split(key)
    n = xs.shape[0]
    losses = []
    for _ in range(epochs):
        perm_key, relu_key, key = prng.split(key, 3)
        order = prng.permutation(perm_key, n).to(xs.device)
        for i in range(0, n - batch + 1, batch):
            idx = order[i:i + batch]
            params, opt_state, step, loss = train_step(
                apply_fn, opt, hb_cfg, params, opt_state, step, xs[idx], ys[idx],
                relu_key)
            losses.append(float(loss))
    return params, losses
