"""Abstract inputs for every (arch x shape x mesh) cell of the dry run
(twin of the reference's ``launch/specs.py``).

Params, optimizer states, caches and batches are DTensors on a
``DeviceMesh`` whose placements come from the partition rules
(``runtime/sharding.py``).  Shapes are taken from the models' own
``init`` / ``init_cache`` run under a ``FakeTensorMode`` of their own;
each DTensor's local block is a fresh tensor on ``device``, so under the
caller's ``FakeTensorMode`` nothing is allocated.  Token batches are
int64, as ``TokenPipeline`` makes them; the train state's step is a 0-d
int32 tensor on the host, as ``TrainState`` keeps it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..device import Device
from ..models import encdec, lm
from ..runtime import sharding
from ..train import optimizer as opt_lib
from . import train as train_lib


@dataclasses.dataclass(frozen=True)
class _Leaf:
    shape: Tuple[int, ...]
    dtype: torch.dtype


def shapes_of(fn):
    """``_Leaf`` (shape, dtype) leaves of ``fn()``'s tree, computed on fake
    tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        tree = fn()
    return opt_lib.tree_map(lambda t: _Leaf(tuple(t.shape), t.dtype), tree)


def _attach(shapes, spec_of, mesh, device: Device):
    """A DTensor per leaf, placed by ``spec_of(path, shape)``."""
    return sharding.map_with_path(lambda path, leaf: sharding.empty(
        leaf.shape, leaf.dtype, spec_of(path, leaf.shape), mesh, device=device,
        fill=0), shapes)


def param_shapes(cfg: ArchConfig, mode: str):
    init_fn = encdec.init if cfg.family == "encdec" else lm.init
    shapes = shapes_of(lambda: init_fn(cfg, torch.Generator()))
    if mode == "train":
        return opt_lib.tree_map(lambda leaf: _Leaf(leaf.shape, torch.float32), shapes)
    return shapes


def abstract_params(cfg: ArchConfig, mesh, mode: str, device: Device = None):
    """Params as DTensors: float32 masters to train, the config's dtype to
    serve."""
    shapes = param_shapes(cfg, mode)
    return _attach(shapes, lambda path, shape: sharding.param_spec(
        path, shape, mesh, mode, cfg), mesh, device)


def abstract_train_state(cfg: ArchConfig, mesh, optimizer, device: Device = None):
    params = abstract_params(cfg, mesh, "train", device)
    shapes = param_shapes(cfg, "train")
    opt_shapes = shapes_of(lambda: optimizer.init(opt_lib.tree_map(
        lambda leaf: torch.empty(leaf.shape, dtype=leaf.dtype), shapes)))
    opt = _attach(opt_shapes, lambda path, shape: sharding.param_spec(
        path, shape, mesh, "train", cfg), mesh, device)
    return train_lib.TrainState(params=params, opt_state=opt,
                                step=torch.zeros((), dtype=torch.int32))


def _batch(shape, dtype, mesh, device, extra_dims: int = 1):
    spec = sharding.batch_spec(shape[0], mesh, extra_dims)
    return sharding.empty(shape, dtype, spec, mesh, device=device, fill=0)


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh, device: Device = None):
    b, s = shape.global_batch, shape.seq_len
    batch: Dict[str, Any] = {}
    if cfg.family == "encdec":
        batch["src_embeds"] = _batch((b, s, cfg.d_model), _dtype(cfg), mesh, device, 2)
        batch["tokens"] = _batch((b, s), torch.int64, mesh, device)
        batch["labels"] = _batch((b, s), torch.int64, mesh, device)
        return batch
    s_tok = s - (cfg.n_frontend_tokens if cfg.frontend != "none" else 0)
    batch["tokens"] = _batch((b, s_tok), torch.int64, mesh, device)
    batch["labels"] = _batch((b, s), torch.int64, mesh, device)
    if cfg.frontend != "none":
        batch["frontend"] = _batch((b, cfg.n_frontend_tokens, cfg.d_model),
                                   _dtype(cfg), mesh, device, 2)
    return batch


def abstract_cache(cfg: ArchConfig, shape: ShapeConfig, mesh, device: Device = None):
    b, max_len = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        shapes = shapes_of(lambda: encdec.init_cache(cfg, b, max_len, max_len,
                                                   device="cpu"))
    else:
        shapes = shapes_of(lambda: lm.init_cache(cfg, b, max_len, device="cpu"))
    return _attach(shapes, lambda path, shp: sharding.cache_spec(path, shp, cfg, mesh),
                   mesh, device)


# the decode cells write position 0: rank 0, the rank traced, holds that
# slot of a context-parallel cache (attention masks the rest, so the
# position changes no other cost)
DECODE_POS = 0


def decode_input_specs(cfg: ArchConfig, shape: ShapeConfig, mesh, device: Device = None):
    b = shape.global_batch
    params = abstract_params(cfg, mesh, "serve", device)
    token = _batch((b, 1), torch.int64, mesh, device)
    cache = abstract_cache(cfg, shape, mesh, device)
    return params, token, cache, DECODE_POS


def prefill_input_specs(cfg: ArchConfig, shape: ShapeConfig, mesh, device: Device = None):
    b, s = shape.global_batch, shape.seq_len
    params = abstract_params(cfg, mesh, "serve", device)
    if cfg.family == "encdec":
        return params, (_batch((b, s, cfg.d_model), _dtype(cfg), mesh, device, 2),), {}
    s_tok = s - (cfg.n_frontend_tokens if cfg.frontend != "none" else 0)
    tokens = _batch((b, s_tok), torch.int64, mesh, device)
    kwargs = {}
    if cfg.frontend != "none":
        kwargs["frontend_embeds"] = _batch((b, cfg.n_frontend_tokens, cfg.d_model),
                                           _dtype(cfg), mesh, device, 2)
    return params, (tokens,), kwargs


def input_specs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                optimizer: Optional[Any] = None, device: Device = None):
    """Everything the dry run needs for one cell: (fn_args, fn_kwargs)."""
    if shape.kind == "train":
        optimizer = optimizer or opt_lib.AdamW()
        state = abstract_train_state(cfg, mesh, optimizer, device)
        return (state, train_batch_specs(cfg, shape, mesh, device)), {}
    if shape.kind == "prefill":
        params, args, kwargs = prefill_input_specs(cfg, shape, mesh, device)
        return (params,) + args, kwargs
    return decode_input_specs(cfg, shape, mesh, device), {}
