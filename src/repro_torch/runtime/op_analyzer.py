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
- collective bytes: the outputs of ``c10d`` / ``_c10d_functional`` ops,
  by op name in ``collective_counts``; 0 on one card.

The reference's ``collective_census`` over HLO is not ported: the port
compiles no XLA program, and its party exchanges are counted at the comm
seam (``analysis/census.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode


@dataclasses.dataclass
class Metrics:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    op_counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    def scaled(self, k: float) -> "Metrics":
        return Metrics(self.flops * k, self.bytes * k, self.collective_bytes * k,
                       {n: int(c * k) for n, c in self.collective_counts.items()},
                       {n: int(c * k) for n, c in self.op_counts.items()})

    def add(self, o: "Metrics"):
        self.flops += o.flops
        self.bytes += o.bytes
        self.collective_bytes += o.collective_bytes
        for mine, theirs in ((self.collective_counts, o.collective_counts),
                             (self.op_counts, o.op_counts)):
            for n, c in theirs.items():
                mine[n] = mine.get(n, 0) + c
        return self


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [t for f in dataclasses.fields(x) for t in _tensors(getattr(x, f.name))]
    return []


def _nbytes(x) -> int:
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


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.m = Metrics()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        m = self.m
        name = str(func.overloadpacket.__name__)
        m.op_counts[name] = m.op_counts.get(name, 0) + 1
        flops = _dot_flops(func, args, out)
        if flops >= 0:
            m.flops += flops
            m.bytes += _nbytes(args) + _nbytes(out)
        elif func in _COPIES:
            m.bytes += 2 * _nbytes(out)
        elif func.namespace in ("c10d", "_c10d_functional"):
            m.collective_bytes += _nbytes(out)
            m.collective_counts[name] = m.collective_counts.get(name, 0) + 1
        return out


def analyze(fn, *args, **kwargs) -> Metrics:
    """``fn(*args, **kwargs)`` once, counted; returns its ``Metrics`` (the
    output itself is dropped)."""
    counter = _Counter()
    with counter:
        out = fn(*args, **kwargs)
    counter.m.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
    return counter.m
