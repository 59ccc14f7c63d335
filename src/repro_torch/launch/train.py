"""The train step (twin of the reference's ``launch/train.py``): float32
master params, compute in the config's dtype, remat per layer, gradient
accumulation over microbatches.

Master params live in float32 inside the optimizer; ``loss_fn`` casts
them to ``cfg.dtype`` inside the autograd graph, so the forward runs in
bfloat16 and the gradients land in float32 on the master leaves.  The
remat policy comes from the arch config (``models.lm._maybe_remat``:
``torch.utils.checkpoint`` per layer).  Microbatches run as a Python loop
that accumulates gradients (the reference's ``lax.scan``).  The step
counter is a 0-d int32 tensor on the host, and the schedule computes on
it there as tensor ops: nothing is read back, so no step waits on the
card and the step traces under ``FakeTensorMode``.  On DTensors (the dry
run) the model's sharding constraints apply, and logits split over the
vocab take a vocab-parallel log-likelihood
(``runtime/constraints.vocab_parallel_nll``); on plain tensors neither
changes anything.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..configs.base import ArchConfig
from ..device import Device
from ..models import encdec, lm
from ..nn import common, moe as moe_lib
from ..runtime import constraints
from ..train.optimizer import tree_leaves, tree_map


@dataclasses.dataclass
class TrainState:
    params: Any            # float32 master copy
    opt_state: Any
    step: torch.Tensor     # 0-d int32, on the host


def init_state(cfg: ArchConfig, optimizer, generator: torch.Generator) -> TrainState:
    """Seeded params (``lm.init`` / ``encdec.init`` on the generator's
    device) cast to float32, the optimizer's zero state, step 0."""
    init_fn = encdec.init if cfg.family == "encdec" else lm.init
    params = tree_map(lambda p: p.to(torch.float32), init_fn(cfg, generator))
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32))


def _compute_params(params, cfg: ArchConfig):
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return tree_map(lambda p: p.to(dt), params)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig) -> torch.Tensor:
    """Next-token cross entropy in float32; labels < 0 are masked (frontend
    positions, the last position).  MoE adds 0.01 x the router balance
    loss of layer 0."""
    p = _compute_params(params, cfg)
    if cfg.family == "encdec":
        logits = encdec.apply(p, batch["src_embeds"], batch["tokens"], cfg)
    else:
        logits = lm.apply(p, batch["tokens"], cfg,
                          frontend_embeds=batch.get("frontend"))
    labels = batch["labels"]
    mask = (labels >= 0).to(torch.float32)
    if constraints.vocab_split(logits):
        # DTensor logits split over the vocab: the same log-likelihood,
        # vocab-parallel, where log_softmax and the gather below would
        # reassemble the whole vocab on every rank, and its gradient too
        ll = -constraints.vocab_parallel_nll(logits, labels)
        loss = -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    else:
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        safe = torch.clamp_min(labels, 0).to(torch.int64)
        # on DTensors a vocab-split gather is a masked partial sum: reduce
        # it over the vocab ranks before anything reshards it
        ll = constraints.shard(torch.gather(logp, -1, safe[..., None]),
                               "dp", None, None)[..., 0]
        loss = -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    if cfg.family == "moe":
        loss = loss + 0.01 * _moe_aux(p, batch, cfg)
    return loss


def _moe_aux(params, batch, cfg: ArchConfig) -> torch.Tensor:
    # router balance on the embedded tokens of the first layer (the
    # reference's cheap proxy of the per-layer aux sum)
    h = common.embed(params["embed"], batch["tokens"])
    layer0 = tree_map(lambda t: t[0], params["layers"])
    return moe_lib.moe_aux_loss(layer0["moe"], h, n_experts=cfg.n_experts)


def value_and_grad(params, batch, cfg: ArchConfig):
    """(loss, gradient leaves in ``tree_leaves(params)`` order); a leaf the
    loss does not reach gets zeros, as jax's grad gives it."""
    leaves = tree_leaves(params)
    loss = loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for g, p in zip(grads, leaves)]


def _rebuild(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def make_train_step(cfg: ArchConfig, optimizer, n_microbatches: int = 1):
    """train_step(state, batch) -> (new state, metrics {"loss", "lr", ...}).
    The batch's leading axis is split into ``n_microbatches`` equal parts
    whose gradients are summed, then divided, as the reference's scan."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = tree_map(lambda p: p.detach().requires_grad_(True), state.params)
        if n_microbatches > 1:
            mb = {k: v.reshape((n_microbatches, v.shape[0] // n_microbatches)
                               + tuple(v.shape[1:])) for k, v in batch.items()}
            loss, grads = None, None
            for i in range(n_microbatches):
                l, g = value_and_grad(params, {k: v[i] for k, v in mb.items()}, cfg)
                loss = l if loss is None else loss + l
                grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            loss = loss / n_microbatches
            grads = [g / n_microbatches for g in grads]
        else:
            loss, grads = value_and_grad(params, batch, cfg)
        del params
        with torch.no_grad():
            new_params, new_opt, info = optimizer.update(
                _rebuild(state.params, grads), state.opt_state, state.params,
                state.step)
        return TrainState(new_params, new_opt, state.step + 1), {"loss": loss, **info}

    return train_step


def shift_labels(tokens: torch.Tensor, pad_prefix: int = 0) -> torch.Tensor:
    """Next-token labels; -1 masks the final position and any prefix."""
    b = tokens.shape[0]
    fill = lambda n: torch.full((b, n), -1, dtype=tokens.dtype, device=tokens.device)
    labels = torch.cat([tokens[:, 1:], fill(1)], dim=1)
    if pad_prefix:
        labels = torch.cat([fill(pad_prefix), labels], dim=1)
    return labels


def state_from_jax(np_state, device: Device = None) -> TrainState:
    """A reference ``TrainState`` (jax or numpy leaves) -> the port's on
    ``device`` (default the GPU): params and the optimizer state (AdamW's
    ``m``/``v``, Adafactor's ``row``/``col``/``v`` factors, SGD's ``m``)
    leaf for leaf by ``lm.params_from_jax``, the step on the host."""
    import numpy as np

    return TrainState(params=lm.params_from_jax(np_state.params, device),
                      opt_state=lm.params_from_jax(np_state.opt_state, device),
                      step=torch.tensor(int(np.asarray(np_state.step)),
                                        dtype=torch.int32))
