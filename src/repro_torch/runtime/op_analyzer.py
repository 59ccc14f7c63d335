"""FLOPs, bytes and collective bytes of one call, from the aten ops it
dispatches (twin of the reference's ``runtime/hlo_analyzer.py``, which
reads them from compiled HLO text).

``analyze(fn, *args)`` runs ``fn`` once under a ``TorchDispatchMode`` and
counts every op that reaches the dispatcher, the backward's too when
``fn`` differentiates (the autograd engine carries the mode to its
threads).  The conventions are the reference's:

- FLOPs of matmuls and convolutions from their shapes: ``mm``, ``bmm``,
  ``addmm``, ``baddbmm`` (2·M·N·K per product), ``convolution`` (2 ×
  output elements × input channels per group × kernel elements) and
  ``convolution_backward`` (the same per gradient it computes);
- bytes as a fusion-optimal lower bound: operands and outputs of those
  ops, 2× the output of a copy (``copy_``, ``_to_copy``, ``clone``,
  ``cat``, scatters), plus ``fn``'s tensor inputs and outputs once;
  elementwise chains count as fused;
- collective bytes: the outputs of ``c10d`` / ``_c10d_functional`` ops
  (an all-reduce twice, as a reduce-scatter plus an all-gather; the
  ``wait_tensor`` that completes one not again), by op name in
  ``collective_counts``; 0 on one card;
- ``peak_bytes``: the peak of live storage during the call, ``fn``'s
  arguments, its outputs, the activations autograd saves and every
  temporary (each storage counted once, from the op that made it until
  it is freed): the counterpart of XLA's ``memory_analysis`` argument +
  output + temp bytes.

Per card.  For a DTensor op the mode steps aside and DTensor runs its
local ops and the collectives its redistributes issue under the mode, so
every count is what one rank computes, moves and holds; the global-shape
ops DTensor runs on fake tensors to infer its outputs' shapes are not
counted.  Plain tensors are counted as they are.

The reference's ``collective_census`` over HLO is not ported: the port
compiles no XLA program, and its party exchanges are counted at the comm
seam (``analysis/census.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import sys
import weakref
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary


@dataclasses.dataclass
class Metrics:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    op_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_bytes: float = 0.0

    def scaled(self, k: float) -> "Metrics":
        return Metrics(self.flops * k, self.bytes * k, self.collective_bytes * k,
                       {n: int(c * k) for n, c in self.collective_counts.items()},
                       {n: int(c * k) for n, c in self.op_counts.items()},
                       self.peak_bytes)

    def add(self, o: "Metrics"):
        self.flops += o.flops
        self.bytes += o.bytes
        self.collective_bytes += o.collective_bytes
        for mine, theirs in ((self.collective_counts, o.collective_counts),
                             (self.op_counts, o.op_counts)):
            for n, c in theirs.items():
                mine[n] = mine.get(n, 0) + c
        return self


def _dtensor_type():
    # no DTensor exists until torch.distributed.tensor is imported
    mod = sys.modules.get("torch.distributed.tensor")
    return mod.DTensor if mod is not None else ()


def _tensors(x) -> List[torch.Tensor]:
    """The tensors of ``x``; a DTensor's local tensor in its place."""
    if isinstance(x, _dtensor_type()):
        return [x._local_tensor]
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [t for f in dataclasses.fields(x) for t in _tensors(getattr(x, f.name))]
    return []


def nbytes(x) -> int:
    """Bytes of the tensors of ``x`` (a DTensor: its local block)."""
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _conv_flops(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor, groups: int) -> float:
    return 2.0 * out.numel() * (x.shape[1] // groups) * math.prod(w.shape[2:])


_aten = torch.ops.aten
_COPIES = {_aten.copy_.default, _aten._to_copy.default, _aten.clone.default,
           _aten.cat.default, _aten.index_put_.default, _aten.index_put.default,
           _aten.slice_scatter.default, _aten.select_scatter.default,
           _aten.scatter.src, _aten.scatter_.src, _aten.scatter_add.default,
           _aten.scatter_add_.default, _aten.index_add.default,
           _aten.index_add_.default}


def _dot_flops(func, args, out) -> float:
    if func is _aten.mm.default:
        (m, k), n = args[0].shape, args[1].shape[1]
        return 2.0 * m * n * k
    if func is _aten.addmm.default:
        (m, k), n = args[1].shape, args[2].shape[1]
        return 2.0 * m * n * k
    if func is _aten.bmm.default:
        (b, m, k), n = args[0].shape, args[1].shape[2]
        return 2.0 * b * m * n * k
    if func is _aten.baddbmm.default:
        (b, m, k), n = args[1].shape, args[2].shape[2]
        return 2.0 * b * m * n * k
    if func is _aten.convolution.default:
        return _conv_flops(args[0], args[1], out, args[8])
    if func is _aten.convolution_backward.default:
        grad_out, x, w = args[0], args[1], args[2]
        mask = args[10]
        per = _conv_flops(x, w, grad_out, args[9])
        return per * (int(mask[0]) + int(mask[1]))
    return -1.0


_NOT_MOVED = {"wait_tensor"}          # completes a collective counted at its start
_TWICE = {"all_reduce", "all_reduce_", "allreduce_"}


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.m = Metrics()
        self.quiet = 0                 # inside DTensor's shape inference
        self.live = 0
        self._storages = WeakIdKeyDictionary()

    def track(self, x) -> None:
        """Count the storages of ``x``'s tensors live from now until freed."""
        for t in _tensors(x):
            if t.device.type == "meta":          # shapes only: no memory
                continue
            st = t.untyped_storage()
            if st in self._storages:
                continue
            n = st.nbytes()
            self._storages[st] = weakref.ref(st, functools.partial(self._freed, n))
            self.live += n
        self.m.peak_bytes = max(self.m.peak_bytes, self.live)

    def _freed(self, n: int, _ref) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dt = _dtensor_type()
        if dt and any(isinstance(a, dt) for a in
                      torch.utils._pytree.tree_leaves((args, kwargs))):
            return NotImplemented      # DTensor runs its local ops under this mode
        out = func(*args, **kwargs)
        if self.quiet:
            return out
        self.track(out)
        m = self.m
        name = str(func.overloadpacket.__name__)
        m.op_counts[name] = m.op_counts.get(name, 0) + 1
        flops = _dot_flops(func, args, out)
        if flops >= 0:
            m.flops += flops
            m.bytes += nbytes(args) + nbytes(out)
        elif func in _COPIES:
            m.bytes += 2 * nbytes(out)
        elif func.namespace in ("c10d", "_c10d_functional") and name not in _NOT_MOVED:
            m.collective_bytes += nbytes(out) * (2 if name in _TWICE else 1)
            m.collective_counts[name] = m.collective_counts.get(name, 0) + 1
        return out


@contextlib.contextmanager
def _quiet_shape_inference(counter: _Counter):
    """DTensor infers an op's global output shape by running the op on
    fake tensors of the global shapes; those runs are not the card's."""
    if not _dtensor_type():
        yield
        return
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def quiet(self, op_schema):
        counter.quiet += 1
        try:
            return orig(self, op_schema)
        finally:
            counter.quiet -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = quiet
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def analyze(fn, *args, **kwargs) -> Metrics:
    """``fn(*args, **kwargs)`` once, counted; returns its ``Metrics`` (the
    output itself is dropped)."""
    counter = _Counter()
    counter.track((args, kwargs))
    with _quiet_shape_inference(counter), counter:
        out = fn(*args, **kwargs)
    counter.m.bytes += nbytes(args) + nbytes(kwargs) + nbytes(out)
    return counter.m
