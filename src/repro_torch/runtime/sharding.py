"""Path-based partition rules: DP / FSDP / TP / SP / EP (twin of the
reference's ``runtime/sharding.py``).

Every parameter leaf is matched by the trailing components of its tree
path; the rules give a spec with one entry per tensor dim (None, a mesh
axis name, or a tuple of names, as a jax ``PartitionSpec``) over the
production mesh's axes ("pod", "data", "model").  Modes:

  train  - FSDP (params + optimizer states sharded over the data axes,
           ZeRO-3 style) x TP over `model`; activations batch-sharded.
  serve  - TP over `model`; params replicated over `data` unless the arch
           is flagged huge (grok/mixtral) in which case they stay
           FSDP-sharded ("weight-gathered serving").

KV caches: batch over data when divisible, else sequence (context
parallelism for long_500k B=1); the sequence over model.  The rules are
pure functions of (path, shape, the mesh's axis names and sizes, mode),
so the same code prices the one-card mesh and the 512-card dry run.

A mesh here is a ``DeviceMesh`` with named dims or any mapping of axis
name -> size in mesh order.  ``placements(spec, mesh)`` turns a spec into
DTensor placements (``Shard``/``Replicate`` per mesh dim; a tuple of axes
on one dim is split major to minor in mesh order, as jax splits it), and
``param_shardings`` / ``cache_shardings`` / ``replicated`` distribute a
tree onto a ``DeviceMesh``.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import torch

from ..configs.base import ArchConfig

Spec = Tuple[Any, ...]

# archs whose params don't fit TP-16 replicated-over-data at bf16
FSDP_SERVE_ARCHS = ("grok-1-314b", "mixtral-8x22b")


def axis_sizes(mesh) -> Dict[str, int]:
    """The mesh's axis name -> size, in mesh order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the partition rules need a mesh with named dims")
    return dict(zip(names, mesh.mesh.shape))


def data_axes(mesh) -> Tuple[str, ...]:
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def data_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in data_axes(mesh))


def model_size(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)


def _div(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def _maybe(axis, dim: int, mesh) -> Optional[Any]:
    """Use `axis` for this dim only if the dim divides the axis size."""
    if axis is None:
        return None
    sizes = axis_sizes(mesh)
    size = (math.prod(sizes[a] for a in axis) if isinstance(axis, tuple)
            else sizes.get(axis, 1))
    if not _div(dim, size):
        return None
    # a one-axis tuple is that axis, as a PartitionSpec normalises it
    return axis[0] if isinstance(axis, tuple) and len(axis) == 1 else axis


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

_RULES = [
    # (path regex, (dim -> role)) roles: F=fsdp axes, M=model, N=replicated
    (r"embed/table$",             ("M", "F")),
    (r"lm_head/w$",               ("F", "M")),
    (r"(attn|xattn)/w[qkv]/w$",   ("F", "M")),
    (r"(attn|xattn)/w[qkv]/b$",   ("M",)),
    (r"(attn|xattn)/wo/w$",       ("M", "F")),
    (r"mlp/w_(up|gate)$",         ("F", "M")),
    (r"mlp/w_down$",              ("M", "F")),
    (r"moe/router/w$",            ("F", "N")),
    (r"moe/w_(up|gate)$",         ("E", "F", "M")),
    (r"moe/w_down$",              ("E", "M", "F")),
    (r"mamba/in_proj/w$",         ("F", "M")),
    (r"mamba/conv_w$",            ("N", "M")),
    (r"mamba/conv_b$",            ("M",)),
    (r"mamba/x_proj/w$",          ("M", "N")),
    (r"mamba/dt_proj/w$",         ("N", "M")),
    (r"mamba/dt_proj/b$",         ("M",)),
    (r"mamba/a_log$",             ("M", "N")),
    (r"mamba/d_skip$",            ("M",)),
    (r"mamba/dt_bias$",           ("M",)),
    (r"mamba/norm/scale$",        ("M",)),
    (r"mamba/out_proj/w$",        ("M", "F")),
]


def param_spec(path_str: str, shape: Tuple[int, ...], mesh, mode: str,
               cfg: Optional[ArchConfig] = None, ep: bool = False) -> Spec:
    fsdp: Any = data_axes(mesh)
    if mode == "serve" and cfg is not None and cfg.name not in FSDP_SERVE_ARCHS:
        fsdp = None  # replicate over data; TP only
    stacked = bool(re.search(r"(^|/)((enc_|dec_)?layers)/", path_str))
    n_lead = 1 if stacked else 0

    for pat, roles in _RULES:
        if re.search(pat, path_str):
            dims = shape[n_lead:]
            spec: list = [None] * n_lead
            for dim, role in zip(dims, roles[: len(dims)]):
                if role == "M":
                    spec.append(_maybe("model", dim, mesh))
                elif role == "F":
                    spec.append(_maybe(fsdp, dim, mesh) if fsdp else None)
                elif role == "E":
                    spec.append(_maybe("model", dim, mesh) if ep else None)
                else:
                    spec.append(None)
            spec += [None] * (len(shape) - len(spec))
            return tuple(spec)
    # norms, scalars, biases: replicated (tiny)
    return (None,) * len(shape)


# ---------------------------------------------------------------------------
# Activation / batch / cache rules
# ---------------------------------------------------------------------------

def batch_spec(batch: int, mesh, extra_dims: int = 1) -> Spec:
    return (_maybe(data_axes(mesh), batch, mesh),) + (None,) * extra_dims


def cache_spec(path_str: str, shape: Tuple[int, ...], cfg: ArchConfig, mesh) -> Spec:
    """KV/SSM cache sharding.  Leading dim is the stacked layer axis."""
    dp = data_axes(mesh)
    if re.search(r"(kv|self_kv)/[kv]$|mem_[kv]$", path_str):
        # (L, B, S, K, Dh): context-parallel - batch over dp, sequence over
        # model (long_500k B=1: sequence over both axes); matches the
        # in-model constraint in nn/attention.attention_decode.
        _, b, s, _, _ = shape
        batch_axis = _maybe(dp, b, mesh)
        if batch_axis:
            return (None, batch_axis, _maybe("model", s, mesh), None, None)
        both = dp + (("model",) if "model" in axis_sizes(mesh) else ())
        return (None, None, _maybe(both, s, mesh), None, None)
    if re.search(r"ssm/h$", path_str):
        # mamba1: (L, B, Di, N); mamba2: (L, B, H, P, N)
        batch_axis = _maybe(dp, shape[1], mesh)
        inner = _maybe("model", shape[2], mesh)
        return (None, batch_axis, inner) + (None,) * (len(shape) - 3)
    if re.search(r"ssm/conv$", path_str):
        return (None, _maybe(dp, shape[1], mesh), None,
                _maybe("model", shape[3], mesh))
    return (None,) * len(shape)


# ---------------------------------------------------------------------------
# Specs as DTensor placements, and trees on a DeviceMesh
# ---------------------------------------------------------------------------

def _names(entry, sizes: Mapping[str, int]) -> Tuple[str, ...]:
    """The mesh axes of one spec entry; an axis the mesh lacks (the rules'
    "model" on a data-only mesh) shards nothing."""
    if entry is None:
        return ()
    return tuple(n for n in (entry if isinstance(entry, tuple) else (entry,))
                 if n in sizes)


def placements(spec: Spec, mesh) -> tuple:
    """``Shard(d)`` on every mesh dim that ``spec`` puts on tensor dim d,
    ``Replicate()`` on the rest (and on a mesh dim of size 1, where the
    two are the same block).  A tuple of axes on one dim must be in mesh
    order: DTensor splits a dim sharded over several mesh dims major to
    minor in mesh order, which is jax's order for such a tuple."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = axis_sizes(mesh)
    order = list(sizes)
    out: list = [Replicate() for _ in order]
    used: set = set()
    for d, entry in enumerate(spec):
        idx = [order.index(n) for n in _names(entry, sizes)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order {order}")
        for i in idx:
            if i in used:
                raise ValueError(f"mesh axis {order[i]} used twice in {spec}")
            used.add(i)
            if sizes[order[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """One rank's block of a tensor of ``shape`` under ``spec`` (every
    sharded dim divides its axes, as the rules guarantee)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in _names(entry, sizes))
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide {entry}")
        out[d] //= n
    return tuple(out)


def tree_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs of a params tree, the path as the reference's
    ``_path_str`` spells it ("layers/attn/wq/w", list indices as
    numbers)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from tree_paths(v, f"{prefix}/{k}" if prefix else str(k))


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over the leaves of ``tree``, same structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def distribute(t: torch.Tensor, spec: Spec, mesh):
    """``t``, the whole tensor on every rank, as a DTensor holding this
    rank's block under ``spec`` (no collective: each rank cuts its own
    block, as a single-controller jax array's shards are cut)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements(spec, mesh), src_data_rank=None)


def empty(shape: Tuple[int, ...], dtype: torch.dtype, spec: Spec, mesh,
          device=None, fill: Optional[float] = None):
    """A DTensor of global ``shape`` whose local block is a fresh tensor
    (zeros with ``fill=0``; under ``FakeTensorMode`` nothing is
    allocated), never a view of a whole-size tensor."""
    from torch.distributed.tensor import DTensor

    local = local_shape(shape, spec, mesh)
    if fill is None:
        t = torch.empty(local, dtype=dtype, device=device)
    else:
        t = torch.full(local, fill, dtype=dtype, device=device)
    stride, step = [], 1                      # the whole tensor's, contiguous
    for d in reversed(shape):
        stride.insert(0, step)
        step *= d
    return DTensor.from_local(t, mesh, placements(spec, mesh), run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def param_shardings(params, mesh, mode: str, cfg: Optional[ArchConfig] = None,
                    ep: bool = False):
    """``params`` distributed onto ``mesh`` by ``param_spec``."""
    return map_with_path(
        lambda path, t: distribute(t, param_spec(path, tuple(t.shape), mesh, mode,
                                                 cfg, ep), mesh), params)


def cache_zeros(meta_cache, cfg: ArchConfig, mesh, device=None):
    """A zeroed serving cache of ``meta_cache``'s shapes on ``mesh``, placed
    by ``cache_spec``, each rank's block made alone."""
    return map_with_path(lambda path, t: empty(
        tuple(t.shape), t.dtype, cache_spec(path, tuple(t.shape), cfg, mesh), mesh,
        device=device, fill=0), meta_cache)


def cache_shardings(cache, cfg: ArchConfig, mesh):
    """A serving cache distributed onto ``mesh`` by ``cache_spec``."""
    return map_with_path(
        lambda path, t: distribute(t, cache_spec(path, tuple(t.shape), cfg, mesh),
                                   mesh), cache)


def replicated(t: torch.Tensor, mesh):
    """``t`` replicated on every rank of ``mesh``."""
    return distribute(t, (None,) * t.ndim, mesh)
