"""ResNet-18/50, the paper's own workload (CIFAR-sized stem); twin of the
reference's ``models/resnet.py``.

Weights are a params tree in the reference's layout (conv weights OIHW,
BatchNorm statistics per channel, fc ``w`` as [in, classes]), so trees
carry across with ``params_from_jax``.  Two evaluation paths read it:

  - ``apply`` / ``ResNet``: the plaintext forward (NCHW), with a
    ``relu_fn(x, group)`` hook per ReLU point;
  - ``_mpc_forward``: the secret-shared forward over sibling MPCTensor
    streams, BatchNorm folded into the preceding conv and max-pool removed
    (paper §2.3), registered with ``api.register_mpc_forward``.

``relu_plan``, ``gen_mpc_triples``, ``mpc_apply`` and ``mpc_apply_many``
are the reference's deprecated shims, thin layers over ``api``.

ReLU layers form the paper's five groups (stem + 4 stages).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..api import Plan, register_mpc_forward, trace_plan
from ..configs.resnet import ResNetConfig
from ..core import MPCTensor, beaver
from ..core.hummingbird import HBConfig
from ..device import Device, resolve as resolve_device


def _map_paths(fn, tree, path=()):
    """Rebuild a params tree with ``fn(path, leaf)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _buffer_name(path) -> str:
    return "_".join(map(str, path))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _conv_init(gen, cout, cin, k, device):
    scale = (2.0 / (cin * k * k)) ** 0.5
    return torch.randn((cout, cin, k, k), generator=gen).to(device) * scale


def _bn_init(c, device):
    return {"gamma": torch.ones(c, device=device),
            "beta": torch.zeros(c, device=device),
            "mean": torch.zeros(c, device=device),
            "var": torch.ones(c, device=device)}


def init(cfg: ResNetConfig, seed: int = 0, device: Device = None) -> Dict:
    """Random params with the reference's init scales, drawn from a seeded
    ``torch.Generator`` (different numbers from the reference's jax init;
    carry reference weights across with ``params_from_jax``), on ``device``
    (default the GPU)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    expansion = 1 if cfg.block == "basic" else 4
    params: Dict = {"stem": _conv_init(gen, cfg.widths[0], 3, 3, device),
                    "bn_stem": _bn_init(cfg.widths[0], device), "stages": []}
    cin = cfg.widths[0]
    for si, (n_blocks, width) in enumerate(zip(cfg.stage_blocks, cfg.widths)):
        cout = width * expansion
        stage = []
        for bi in range(n_blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            if cfg.block == "basic":
                p = {"conv1": _conv_init(gen, cout, cin, 3, device),
                     "bn1": _bn_init(cout, device),
                     "conv2": _conv_init(gen, cout, cout, 3, device),
                     "bn2": _bn_init(cout, device)}
            else:
                mid = cout // 4
                p = {"conv1": _conv_init(gen, mid, cin, 1, device),
                     "bn1": _bn_init(mid, device),
                     "conv2": _conv_init(gen, mid, mid, 3, device),
                     "bn2": _bn_init(mid, device),
                     "conv3": _conv_init(gen, cout, mid, 1, device),
                     "bn3": _bn_init(cout, device)}
            if stride != 1 or cin != cout:
                p["proj"] = _conv_init(gen, cout, cin, 1, device)
                p["bn_proj"] = _bn_init(cout, device)
            stage.append(p)
            cin = cout
        params["stages"].append(stage)
    params["fc"] = {
        "w": torch.randn((cin, cfg.n_classes), generator=gen).to(device) * cin ** -0.5,
        "b": torch.zeros(cfg.n_classes, device=device)}
    return params


def params_from_jax(np_tree, device: Device = None) -> Dict:
    """The reference's params tree, as numpy arrays, -> the port's tree on
    ``device`` (default the GPU)."""
    device = resolve_device(device)
    return _map_paths(
        lambda _, a: torch.from_numpy(np.array(a, np.float32)).to(device), np_tree)


# ---------------------------------------------------------------------------
# Plaintext path
# ---------------------------------------------------------------------------

def _bn(x, p, eps=1e-5):
    inv = p["gamma"] / torch.sqrt(p["var"] + eps)
    return x * inv[:, None, None] + (p["beta"] - p["mean"] * inv)[:, None, None]


def fold_bn(conv_w, bn, eps=1e-5):
    """Fold BN into conv: returns (w', b') with conv(x, w') + b' == bn(conv)."""
    inv = bn["gamma"] / torch.sqrt(bn["var"] + eps)
    return conv_w * inv[:, None, None, None], bn["beta"] - bn["mean"] * inv


def apply(params, x, cfg: ResNetConfig, relu_fn=None):
    """x: (B, 3, H, W) -> logits.  ``relu_fn(x, group)`` replaces the ReLU
    of each group (default: exact ReLU)."""
    relu = relu_fn or (lambda v, g: F.relu(v))
    h = relu(_bn(F.conv2d(x, params["stem"], padding=1), params["bn_stem"]), 0)
    for si, stage in enumerate(params["stages"]):
        for block in stage:
            stride = 2 if ("proj" in block and si > 0) else 1
            if "conv3" in block:
                y = relu(_bn(F.conv2d(h, block["conv1"]), block["bn1"]), si + 1)
                y = relu(_bn(F.conv2d(y, block["conv2"], stride=stride, padding=1),
                             block["bn2"]), si + 1)
                y = _bn(F.conv2d(y, block["conv3"]), block["bn3"])
            else:
                y = relu(_bn(F.conv2d(h, block["conv1"], stride=stride, padding=1),
                             block["bn1"]), si + 1)
                y = _bn(F.conv2d(y, block["conv2"], padding=1), block["bn2"])
            if "proj" in block:
                h = _bn(F.conv2d(h, block["proj"], stride=stride), block["bn_proj"])
            h = relu(h + y, si + 1)
    h = h.mean(dim=(2, 3))
    return h @ params["fc"]["w"] + params["fc"]["b"]


class ResNet(nn.Module):
    """The plaintext ResNet as a module over a params tree (the tree's
    tensors are the module's buffers, so ``.to(device)`` moves them)."""

    def __init__(self, params: Dict, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        self._skeleton = _map_paths(lambda path, t: None, params)
        _map_paths(lambda path, t: self.register_buffer(_buffer_name(path), t),
                   params)

    def params(self) -> Dict:
        """The params tree, rebuilt from the module's buffers."""
        return _map_paths(lambda path, _: getattr(self, _buffer_name(path)),
                          self._skeleton)

    def forward(self, x: torch.Tensor, relu_fn=None) -> torch.Tensor:
        return apply(self.params(), x, self.cfg, relu_fn)


def n_relu_groups(cfg: ResNetConfig) -> int:
    return 1 + len(cfg.stage_blocks)


def relu_group_elements(params, cfg: ResNetConfig, in_hw: int = 0) -> List[int]:
    """Activation counts per ReLU group for one sample (budget weighting),
    from a shape-only trace."""
    return list(trace(params, cfg, batch=1, hw=in_hw).group_elements)


# ---------------------------------------------------------------------------
# MPC path
# ---------------------------------------------------------------------------

def hb_or_exact(hb: Optional[HBConfig], cfg: ResNetConfig) -> HBConfig:
    return hb if hb is not None else HBConfig.exact((0,) * n_relu_groups(cfg))


def trace(params, cfg: ResNetConfig, batch: int, hw: int = 0,
          hb: Optional[HBConfig] = None, cone: bool = False) -> Plan:
    """Trace this model into a Plan (shapes only, on the meta device)."""
    hw = hw or cfg.in_hw
    return trace_plan(lambda p, x, relu_fn=None: apply(p, x, cfg, relu_fn=relu_fn),
                      params, (batch, 3, hw, hw), hb=hb,
                      n_groups=n_relu_groups(cfg) if hb is None else None,
                      cone=cone, name=cfg.name)


def _mpc_forward(params, hs: List[MPCTensor], cfg: ResNetConfig, relu_fn,
                 comm) -> List[MPCTensor]:
    """Shared MPC forward over sibling streams; ``relu_fn(tensors, group)``
    runs once per ReLU point with the tensors of every stream."""
    w, b = fold_bn(params["stem"], params["bn_stem"])
    hs = [h.conv2d_public(w, 1, 1).add_public(b[:, None, None], comm) for h in hs]
    hs = relu_fn(hs, 0)
    for si, stage in enumerate(params["stages"]):
        for block in stage:
            stride = 2 if ("proj" in block and si > 0) else 1
            if "conv3" in block:
                w1, b1 = fold_bn(block["conv1"], block["bn1"])
                ys = relu_fn([h.conv2d_public(w1, 1, 0)
                              .add_public(b1[:, None, None], comm) for h in hs], si + 1)
                w2, b2 = fold_bn(block["conv2"], block["bn2"])
                ys = relu_fn([y.conv2d_public(w2, stride, 1)
                              .add_public(b2[:, None, None], comm) for y in ys], si + 1)
                w3, b3 = fold_bn(block["conv3"], block["bn3"])
                ys = [y.conv2d_public(w3, 1, 0).add_public(b3[:, None, None], comm)
                      for y in ys]
            else:
                w1, b1 = fold_bn(block["conv1"], block["bn1"])
                ys = relu_fn([h.conv2d_public(w1, stride, 1)
                              .add_public(b1[:, None, None], comm) for h in hs], si + 1)
                w2, b2 = fold_bn(block["conv2"], block["bn2"])
                ys = [y.conv2d_public(w2, 1, 1).add_public(b2[:, None, None], comm)
                      for y in ys]
            if "proj" in block:
                wp, bp = fold_bn(block["proj"], block["bn_proj"])
                hs = [h.conv2d_public(wp, stride, 0).add_public(bp[:, None, None], comm)
                      for h in hs]
            hs = relu_fn([h + y for h, y in zip(hs, ys)], si + 1)
    hs = [h.global_avg_pool() for h in hs]
    return [h.matmul_public(params["fc"]["w"]).add_public(params["fc"]["b"], comm)
            for h in hs]


# the generic compiler resolves this forward from the config type
register_mpc_forward(ResNetConfig, _mpc_forward)


# ---------------------------------------------------------------------------
# Deprecated shims (thin layers over ``api``)
# ---------------------------------------------------------------------------

def relu_plan(params, cfg: ResNetConfig, batch: int, hw: int = 0):
    """Deprecated shim over ``api.trace_plan``: (n_elements, group) per ReLU
    call, in call order."""
    plan = trace(params, cfg, batch, hw)
    return [(c.n_elements, c.group) for c in plan.calls]


def gen_mpc_triples(key, plan, hb: Optional[HBConfig], cfg: ResNetConfig,
                    cone: bool = False):
    """Deprecated shim over ``beaver.gen_plan_triples``: one ReluTriples
    bundle per ReLU call (None for culled width-0 groups), on the key's
    device.  ``plan`` is the (n_elements, group) list from ``relu_plan``."""
    hb_layers = hb_or_exact(hb, cfg).layers
    return beaver.gen_plan_triples(
        key, [(n, hb_layers[g].width) for n, g in plan], cone=cone)


def _compiled(params, cfg: ResNetConfig, hb, comm, triples, cone, device):
    """Shared shim body: bind the old threaded arguments into a Plan and a
    Session on the inputs' device, and compile (``api`` is the first-class
    entry point)."""
    from .. import api

    provider = beaver.TriplePool(triples) if triples is not None else None
    session = api.Session(comm=comm, provider=provider, device=device)
    plan = api.Plan.from_hb(hb_or_exact(hb, cfg), cone=cone, name=cfg.name)
    return api.compile(
        lambda p, x, relu_fn=None: apply(p, x, cfg, relu_fn=relu_fn),
        params, cfg, plan, session)


def mpc_apply(params, x: MPCTensor, cfg: ResNetConfig, key,
              hb: Optional[HBConfig] = None, comm=None,
              triples: Optional[list] = None, cone: bool = False) -> MPCTensor:
    """Deprecated shim over ``api.compile``: secret-shared inference of one
    input, on its device.  ReLU via GMW with the HummingBird (k, m) of each
    group; ``triples`` (one bundle or None per ReLU call) are consumed in
    call order, otherwise derived inline from the call keys."""
    return _compiled(params, cfg, hb, comm, triples, cone, x.device)(x, key=key)


def mpc_apply_many(params, xs: Sequence[MPCTensor], cfg: ResNetConfig, key,
                   hb: Optional[HBConfig] = None, comm=None,
                   triples: Optional[list] = None,
                   cone: bool = False) -> List[MPCTensor]:
    """Deprecated shim over ``api.compile``: N sibling inference streams
    share ReLU rounds (max-over-streams rounds per layer, one coalesced
    exchange per round).  ``triples`` keeps the offline split: one entry per
    ReLU call, in call order, each a sequence with one bundle (or None for
    culled groups) per stream."""
    flat = ([b for call in triples for b in call]
            if triples is not None else None)
    return _compiled(params, cfg, hb, comm, flat, cone,
                     xs[0].device)(list(xs), key=key)
