"""Fault-tolerant training loop (twin of the reference's ``train/loop.py``).

- checkpoint/restart: resumes from the last committed step; the data
  pipeline is deterministic by step, so no batch is replayed or skipped;
- async checkpointing overlaps serialization with compute (the leaves
  are copied to the host on the loop's thread);
- straggler watchdog: per-step wall-clock EWMA; a step slower than
  ``straggler_factor`` x the EWMA is logged and counted
  (``runtime/watchdog.py``);
- elastic restore: the latest checkpoint onto a given device, or onto a
  ``DeviceMesh`` (possibly another than the one that wrote it), each
  leaf placed by ``runtime/sharding.py``'s rules.

``LoopConfig.seed`` seeds the ``torch.Generator`` of the init when the
caller passes neither a state nor a generator.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from ..checkpoint import store
from ..configs.base import ArchConfig
from ..device import Device, resolve as resolve_device
from ..launch import train as train_lib
from ..runtime.watchdog import StragglerWatchdog
from . import optimizer as opt_lib


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    straggler_factor: float = 3.0
    async_ckpt: bool = True
    seed: int = 0            # init generator when the caller passes no state


@dataclasses.dataclass
class LoopReport:
    final_step: int
    losses: List[float]
    resumed_from: Optional[int]
    straggler_steps: List[int]
    step_time_ewma: float


def run(cfg: ArchConfig, pipeline, loop_cfg: LoopConfig, optimizer=None,
        state: Optional[train_lib.TrainState] = None,
        generator: Optional[torch.Generator] = None,
        hooks: Optional[Dict[str, Callable]] = None,
        device: Device = None) -> LoopReport:
    """Train from ``state`` (else a seeded init, or the latest checkpoint
    of ``loop_cfg.ckpt_dir``) to ``loop_cfg.total_steps`` on ``device``
    (default the GPU).  Hooks: ``on_step(step, loss)``,
    ``on_straggler(step, dt, ewma)``, ``fail_at`` (a step after which the
    loop raises, its checkpoint written first)."""
    device = resolve_device(device)
    optimizer = optimizer or opt_lib.AdamW()
    hooks = hooks or {}
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(loop_cfg.seed)

    resumed_from = None
    if state is None:
        state = train_lib.init_state(cfg, optimizer, generator)
        if loop_cfg.ckpt_dir:
            last = store.latest_step(loop_cfg.ckpt_dir)
            if last is not None:
                state, _ = store.restore(loop_cfg.ckpt_dir, state, step=last)
                resumed_from = last

    step_fn = train_lib.make_train_step(cfg, optimizer)
    ckpt = (store.AsyncCheckpointer(loop_cfg.ckpt_dir)
            if (loop_cfg.ckpt_dir and loop_cfg.async_ckpt) else None)

    losses: List[float] = []
    watchdog = StragglerWatchdog(factor=loop_cfg.straggler_factor)
    start = int(state.step)
    for step in range(start, loop_cfg.total_steps):
        t0 = time.time()  # includes data fetch: stalls there are stragglers too
        batch = pipeline.batch_at(step, device=device)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        if step != start:  # the first step warms caches; never observed
            watchdog.observe(step, dt, on_straggler=hooks.get("on_straggler"))
        losses.append(loss)
        if "on_step" in hooks:
            hooks["on_step"](step, loss)
        if loop_cfg.ckpt_dir and (step + 1) % loop_cfg.ckpt_every == 0:
            extra = {"loss": loss}
            if ckpt is not None:
                ckpt.save(step + 1, state, extra)
            else:
                store.save(loop_cfg.ckpt_dir, step + 1, state, extra)
        if "fail_at" in hooks and hooks["fail_at"] == step:
            raise RuntimeError(f"injected failure at step {step}")
    if ckpt is not None:
        ckpt.wait()
    if loop_cfg.ckpt_dir:
        store.save(loop_cfg.ckpt_dir, loop_cfg.total_steps, state, {"final": True})
    return LoopReport(loop_cfg.total_steps, losses, resumed_from,
                      watchdog.stragglers, watchdog.ewma or 0.0)


def abstract_state(cfg: ArchConfig, optimizer) -> train_lib.TrainState:
    """``init_state``'s tree with shapes and dtypes but no storage (fake
    tensors: the reference's ``jax.eval_shape``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return train_lib.init_state(cfg, optimizer, torch.Generator())


def elastic_restore(ckpt_dir: str, cfg: ArchConfig, optimizer,
                    device: Device = None, step: Optional[int] = None,
                    mesh=None, mode: str = "train"):
    """The latest (or ``step``'s) checkpoint of ``cfg``'s training state
    restored onto ``device`` (default the GPU, or with ``mesh`` the mesh's
    device type), whatever device or mesh wrote it; the step counter on
    the host.  Every leaf's shape and dtype must be the ones ``init_state``
    gives.  With ``mesh`` (a ``DeviceMesh``) every params and
    optimizer-state leaf becomes a DTensor placed by
    ``sharding.param_shardings`` for ``mode`` (each rank reads the whole
    leaf and keeps its own block); the host step is the same on every
    rank, replicated.  Returns (state, manifest)."""
    device = resolve_device(mesh.device_type if mesh is not None and device is None
                            else device)
    template = abstract_state(cfg, optimizer)
    on = lambda dev: (lambda t: torch.empty(0, dtype=t.dtype, device=dev))
    target = train_lib.TrainState(
        params=opt_lib.tree_map(on(device), template.params),
        opt_state=opt_lib.tree_map(on(device), template.opt_state),
        step=torch.empty(0, dtype=torch.int32))
    state, manifest = store.restore(ckpt_dir, target, step=step)
    want, _ = store._flatten(template)
    got, paths = store._flatten(state)
    for w, g, path in zip(want, got, paths):
        if tuple(w.shape) != tuple(g.shape) or w.dtype != g.dtype:
            raise ValueError(f"checkpoint leaf {path}: {tuple(g.shape)} {g.dtype}, "
                             f"the config's {tuple(w.shape)} {w.dtype}")
    if mesh is not None:
        from ..runtime import sharding

        state = train_lib.TrainState(
            params=sharding.param_shardings(state.params, mesh, mode, cfg),
            opt_state=sharding.param_shardings(state.opt_state, mesh, mode, cfg),
            step=state.step)
    return state, manifest
