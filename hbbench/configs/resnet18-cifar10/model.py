"""ResNet-18 on CIFAR-10 (``config.json``): weights and images from the
seed, made on the device; the program bound to them; the cell's work.

Weights follow the usual init scales: conv N(0, 2 / fan_in), fc N(0, 1 /
fan_in); BatchNorm's statistics and affine terms are drawn near their
identity (gamma, var about 1; beta, mean about 0), so that the program's
folding of BatchNorm into the convs is exercised.  Images: per-channel
normalized CIFAR-like values, N(0, 1) cut at +-2.5.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from hbbench.lib import rng

CLIP = 2.5


def _blocks(cfg: Dict):
    """(stage, block, cin, cout, stride, has_proj) of every basic block."""
    if cfg["block"] != "basic":
        raise ValueError(f"only basic blocks are laid out here, not {cfg['block']!r}")
    cin = cfg["widths"][0]
    for si, (n, width) in enumerate(zip(cfg["stage_blocks"], cfg["widths"])):
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            yield si, bi, cin, width, stride, (stride != 1 or cin != width)
            cin = width


def _conv_shapes(cfg: Dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...]]]:
    out = [(("stem",), (cfg["widths"][0], cfg["in_channels"], 3, 3))]
    for si, bi, cin, cout, _, proj in _blocks(cfg):
        out.append((("stages", si, bi, "conv1"), (cout, cin, 3, 3)))
        out.append((("stages", si, bi, "conv2"), (cout, cout, 3, 3)))
        if proj:
            out.append((("stages", si, bi, "proj"), (cout, cin, 1, 1)))
    return out


def _bn_name(path) -> Tuple:
    *head, last = path
    return tuple(head) + ({"stem": "bn_stem", "conv1": "bn1", "conv2": "bn2",
                           "proj": "bn_proj"}[last],)


def _put(tree, path, value) -> None:
    node = tree
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    """The params tree (conv weights OIHW, BatchNorm per channel, fc ``w``
    as [in, classes]) from the seed: one normal draw for every weight, one
    for the BatchNorm terms, one uniform draw for the variances."""
    convs = _conv_shapes(cfg)
    feat, classes = cfg["widths"][-1], cfg["n_classes"]
    sizes = [math.prod(s) for _, s in convs] + [feat * classes, classes]
    flat = rng.normal(rng.key(seed, "resnet.weights"), (sum(sizes),), device)
    channels = [s[0] for _, s in convs]
    bn = rng.normal(rng.key(seed, "resnet.bn"), (3, sum(channels)), device)
    var = rng.uniform(rng.key(seed, "resnet.var"), (sum(channels),), device, 0.8, 1.2)
    tree: Dict = {"stages": [[{} for _ in range(n)] for n in cfg["stage_blocks"]]}
    off = coff = 0
    for (path, shape), size in zip(convs, sizes):
        fan_in = shape[1] * shape[2] * shape[3]
        _put(tree, path, flat[off:off + size].view(shape) * math.sqrt(2.0 / fan_in))
        c = shape[0]
        _put(tree, _bn_name(path), {
            "gamma": 1.0 + 0.1 * bn[0, coff:coff + c], "beta": 0.1 * bn[1, coff:coff + c],
            "mean": 0.1 * bn[2, coff:coff + c], "var": var[coff:coff + c]})
        off, coff = off + size, coff + c
    tree["fc"] = {"w": flat[off:off + feat * classes].view(feat, classes) / math.sqrt(feat),
                  "b": 0.1 * flat[off + feat * classes:off + feat * classes + classes]}
    return tree


def make_inputs(cfg: Dict, seed: int, index: int, clients: int, device) -> List[torch.Tensor]:
    """Call ``index``'s images, one (1, C, H, W) per client."""
    hw, c = cfg["in_hw"], cfg["in_channels"]
    x = rng.normal(rng.key(seed, "resnet.images", index), (clients, c, hw, hw), device)
    return list(x.clamp_(-CLIP, CLIP).split(1))


def calibration_images(cfg: Dict, n: int, device) -> torch.Tensor:
    """Images kept apart from every run's traffic (another stream, no seed)."""
    hw, c = cfg["in_hw"], cfg["in_channels"]
    x = rng.normal(rng.key(0, "resnet.calibration"), (n, c, hw, hw), device)
    return x.clamp_(-CLIP, CLIP)


def group_layers(cfg: Dict, plan: Dict):
    """Each ReLU group's (k, m) from the plan file: the stem, then one
    group per stage."""
    groups = plan["groups"]
    if len(groups) != 1 + len(cfg["stage_blocks"]):
        raise ValueError(f"plan has {len(groups)} groups, the model "
                         f"{1 + len(cfg['stage_blocks'])}")
    return [(int(g["k"]), int(g["m"])) for g in groups]


def program(cfg: Dict, weights: Dict, plan: Dict, device):
    """The port's (params, config, Plan) for these weights and plan file."""
    from repro_torch.configs import ResNetConfig
    from repro_torch.core.hummingbird import HBConfig, HBLayer
    from repro_torch.models import resnet

    port_cfg = ResNetConfig(cfg["name"], cfg["block"], tuple(cfg["stage_blocks"]),
                            tuple(cfg["widths"]), cfg["n_classes"], cfg["in_hw"])
    traced = resnet.trace(weights, port_cfg, batch=1)
    hb = HBConfig(tuple(HBLayer(k=k, m=m) for k, m in group_layers(cfg, plan)),
                  traced.group_elements)
    return weights, port_cfg, traced.with_hb(hb)


def relu_sites(cfg: Dict) -> List[Tuple[int, int]]:
    """(group, elements per image) of every ReLU, in call order."""
    hw = cfg["in_hw"]
    out = [(0, cfg["widths"][0] * hw * hw)]
    for si, _, _, cout, stride, _ in _blocks(cfg):
        hw = hw // stride
        out += [(si + 1, cout * hw * hw)] * 2
    return out


def relu_calls(cfg: Dict, plan: Dict, clients: int) -> List[Tuple[int, int]]:
    """(width, elements of all clients) of every ReLU call."""
    layers = group_layers(cfg, plan)
    return [(layers[g][0] - layers[g][1], clients * n) for g, n in relu_sites(cfg)]


def linear_shapes(cfg: Dict, clients: int):
    """Every ring product of a call: per client, each conv as (M, K, N) =
    (2 parties x OH x OW, Cin x kh x kw, Cout) and the fc at M = 2."""
    hw = cfg["in_hw"]
    shapes = {(2 * hw * hw, cfg["in_channels"] * 9, cfg["widths"][0]): 1}

    def add(key):
        shapes[key] = shapes.get(key, 0) + 1

    for _, _, cin, cout, stride, proj in _blocks(cfg):
        out_hw = hw // stride
        add((2 * out_hw * out_hw, cin * 9, cout))
        add((2 * out_hw * out_hw, cout * 9, cout))
        if proj:
            add((2 * out_hw * out_hw, cin, cout))
        hw = out_hw
    add((2, cfg["widths"][-1], cfg["n_classes"]))
    return [("public", s, c * clients) for s, c in shapes.items()]
