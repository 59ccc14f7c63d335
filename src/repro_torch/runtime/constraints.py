"""In-model sharding constraints (twin of the reference's
``runtime/constraints.py``).

The reference pins activations with ``with_sharding_constraint`` against
the mesh jax has in context, because XLA's sharding propagation gives up
at scan carries and replicates.  The port's counterpart is DTensor: a
parameter or batch distributed onto a ``DeviceMesh`` makes every op of
the model a DTensor op, and ``shard(x, ...)`` redistributes ``x`` to the
placements the reference's spec names, so model code states its intent
once and runs unchanged on one card, the 16x16 mesh and the 2x16x16 one.

The context mesh is set explicitly, ``with use_mesh(mesh):``; nothing is
guessed from a global.  Without one, or for a plain tensor, ``shard`` is
the identity, and model code run on plain tensors is unchanged bit for
bit.  ``like(t, x)`` makes a constant the model builds (positions,
masks, RoPE frequencies, the flash accumulators' inits) a replicated
DTensor on ``x``'s mesh when ``x`` is a DTensor, and leaves it as it is
otherwise.

Axis aliases: "dp" expands to the data axes ("pod", "data"); "tp" to
"model".  An axis absent from the mesh, or whose size does not divide the
dim, is dropped.
"""
from __future__ import annotations

import contextlib
import math
import sys
from typing import List, Optional, Tuple

import torch

_STACK: List[object] = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh`` with named dims) the context mesh."""
    _STACK.append(mesh)
    try:
        yield mesh
    finally:
        _STACK.pop()


def context_mesh():
    """The innermost ``use_mesh`` mesh, or None."""
    return _STACK[-1] if _STACK else None


def _is_dtensor(x) -> bool:
    # no DTensor exists until torch.distributed.tensor is imported
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _expand(axis, names) -> Tuple[str, ...]:
    if axis is None:
        return ()
    if axis == "dp":
        return tuple(a for a in ("pod", "data") if a in names)
    if axis == "tp":
        return ("model",) if "model" in names else ()
    if isinstance(axis, (tuple, list)):
        out: Tuple[str, ...] = ()
        for a in axis:
            out += _expand(a, names)
        return out
    return (axis,) if axis in names else ()


def spec_for(shape, axes, mesh) -> tuple:
    """The reference's spec for a tensor of ``shape`` under ``axes``."""
    from .sharding import axis_sizes

    sizes = axis_sizes(mesh)
    spec = []
    for dim, axis in zip(shape, axes):
        names = _expand(axis, sizes)
        total = math.prod(sizes[n] for n in names) if names else 1
        if names and total > 1 and dim % total == 0:
            spec.append(names if len(names) > 1 else names[0])
        else:
            spec.append(None)
    return tuple(spec) + (None,) * (len(shape) - len(spec))


def shard(x, *axes):
    """``x`` redistributed to the spec ``axes`` names on the context mesh;
    the identity without one or for a plain tensor."""
    mesh = context_mesh()
    if mesh is None or not _is_dtensor(x):
        return x
    from .sharding import placements

    want = placements(spec_for(x.shape, axes, mesh), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def gathered(w):
    """``w`` whole over the data axes ("pod", "data"), still split over
    "model": FSDP's gather of a parameter before its use, its gradient
    reduce-scattered back to the parameter's split on the way out.
    Without it DTensor may keep the weight split and reshard the
    activations instead, which on the 32-way data axis left full-batch
    products on every rank.  The identity for a plain tensor or without a
    context mesh."""
    if context_mesh() is None or not _is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard

    names = w.device_mesh.mesh_dim_names
    want = tuple(Replicate() if isinstance(p, Shard) and names[i] in ("pod", "data")
                 else p for i, p in enumerate(w.placements))
    if want == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def axis_divides(axis, dim: int) -> bool:
    """True if `dim` is divisible by the context-mesh size of `axis`."""
    mesh = context_mesh()
    if mesh is None:
        return False
    from .sharding import axis_sizes

    sizes = axis_sizes(mesh)
    names = _expand(axis, sizes)
    if not names:
        return False
    total = math.prod(sizes[n] for n in names)
    return total > 1 and dim % total == 0


def like(t: torch.Tensor, x):
    """``t`` replicated on ``x``'s mesh when ``x`` is a DTensor, else ``t``."""
    if not _is_dtensor(x):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def mesh_of(x) -> Optional[object]:
    """``x``'s ``DeviceMesh`` when it is a DTensor, else None."""
    return x.device_mesh if _is_dtensor(x) else None


def splittable(x, dim: int, n: int):
    """``x`` ready for a view that splits dim ``dim`` into ``n`` leading
    pieces: a DTensor whose ranks split that dim more ways than ``n``
    divides (24 heads over a model axis of 16) is gathered on it first, as
    XLA reshards before such a reshape; anything else is ``x``."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    ways = 1
    for size, p in zip(x.device_mesh.mesh.shape, x.placements):
        if isinstance(p, Shard) and p.dim == dim % x.ndim:
            ways *= size
    if n % ways == 0:
        return x
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim % x.ndim else p
            for p in x.placements]
    return x.redistribute(x.device_mesh, want)


class _GradPlacedLike(torch.autograd.Function):
    """Identity forward; the gradient redistributed to the forward value's
    placements on the way back."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements) if _is_dtensor(g) else g


def grad_placed(x):
    """``x``, its gradient redistributed to ``x``'s placements on the way
    back (the identity for a plain tensor).  DTensor gives a gradient the
    placements its backward ops prefer, and two places need the forward's:
    after a view that merged dims (heads into the model width), whose
    backward cannot split a gradient split over the merged dim more ways
    than the first of them divides (24 heads, a model axis of 16); and an
    embedding's output, whose gradient must reach the lookup in a
    placement DTensor can turn into the lookup's masked one."""
    return _GradPlacedLike.apply(x) if _is_dtensor(x) else x


class _GradContiguous(torch.autograd.Function):
    """Identity forward; the gradient made contiguous on the way back."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def grad_contiguous(x):
    """``x``, its gradient made contiguous before it reaches the view that
    made ``x`` (the identity for a plain tensor): a DTensor view's backward
    views its gradient, and DTensor cannot view a strided local one."""
    return _GradContiguous.apply(x) if _is_dtensor(x) else x


def block_of(x, dim: int):
    """(offset, length) of this rank's block of ``x``'s dim ``dim``: the
    dim is split major to minor over the mesh dims that shard it, in mesh
    order (every split even, as the rules make them)."""
    from torch.distributed.tensor import Shard

    mesh, length, index = x.device_mesh, x.shape[dim], 0
    for size, coord, p in zip(mesh.mesh.shape, mesh.get_coordinate(), x.placements):
        if p == Shard(dim):
            length //= size
            index = index * size + coord
    return index * length, length


def vocab_split(logits) -> bool:
    """True for DTensor ``logits`` whose last (vocab) dim is split."""
    if not _is_dtensor(logits):
        return False
    from torch.distributed.tensor import Shard

    return any(p == Shard(logits.ndim - 1) for p in logits.placements)


def _rows(x):
    """``x``'s placements with its last dim whole on every rank."""
    from torch.distributed.tensor import Replicate, Shard

    return [Replicate() if p == Shard(x.ndim - 1) else p for p in x.placements]


def _across_vocab(local, logits, op: str):
    """``local`` (one value per row of this rank's vocab block) reduced by
    ``op`` over the ranks that split the vocab."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    last = logits.ndim - 1
    mesh = logits.device_mesh
    part = [Partial(op) if p == Shard(last) else p for p in logits.placements]
    return DTensor.from_local(local, mesh, part, run_check=False).redistribute(
        mesh, _rows(logits)).to_local()


class _VocabParallelNLL(torch.autograd.Function):
    """-log softmax(logits)[label] per row, each rank on its block of the
    vocab: a max and two sums reduced across the vocab's ranks forward,
    nothing moved backward (Megatron's vocab-parallel cross entropy)."""

    @staticmethod
    def forward(ctx, logits, labels):
        from torch.distributed.tensor import DTensor

        mesh = logits.device_mesh
        off, n = block_of(logits, logits.ndim - 1)
        rows = labels.redistribute(mesh, _rows(logits)).to_local()
        x = logits.to_local().to(torch.float32)
        top = _across_vocab(x.amax(dim=-1), logits, "max")
        e = torch.exp(x - top[..., None])
        lse = top + torch.log(_across_vocab(e.sum(dim=-1), logits, "sum"))
        hot = rows[..., None] == torch.arange(off, off + n, device=x.device)
        picked = _across_vocab((x * hot).sum(dim=-1), logits, "sum")
        ctx.save_for_backward(e, lse - top, hot)
        ctx.meta = (mesh, logits.placements, logits.shape, logits.stride(),
                    logits.dtype, _rows(logits))
        return DTensor.from_local(lse - picked, mesh, _rows(logits), run_check=False)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        e, log_sum, hot = ctx.saved_tensors
        mesh, placements, shape, stride, dtype, rows = ctx.meta
        g = g.redistribute(mesh, rows).to_local()
        grad = (e / torch.exp(log_sum)[..., None] - hot.to(e.dtype)) * g[..., None]
        return DTensor.from_local(grad.to(dtype), mesh, placements, run_check=False,
                                  shape=shape, stride=stride), None


def vocab_parallel_nll(logits, labels):
    """-log softmax(``logits``)[``labels``] over the last dim of DTensor
    ``logits`` split over the vocab, row by row, without gathering the
    vocab forward or backward (a negative label picks nothing: its row is
    the log-sum-exp alone)."""
    return _VocabParallelNLL.apply(logits, labels)
