"""Serving steps (twin of the reference's ``launch/serve.py``): the
plaintext LM's prefill, decode and greedy loop over every family of the
model zoo, the private ResNet step, the ResNet serving engine and the
MPC dry run's input specs.

The decode steps update the serving cache in place (``lm.decode_step``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from .. import api
from ..configs.base import ArchConfig
from ..configs.resnet import ResNetConfig
from ..core import beaver
from ..core.hummingbird import HBConfig
from ..device import Device
from ..models import encdec, lm, resnet
from ..train.optimizer import tree_map
from . import specs


def make_decode_step(cfg: ArchConfig):
    """step(params, token, cache, pos) -> (logits, cache)."""
    model = encdec if cfg.family == "encdec" else lm

    def step(params, token, cache, pos):
        return model.decode_step(params, token, cache, pos, cfg)
    return step


def make_prefill_step(cfg: ArchConfig, max_len: int):
    """step(params, tokens, frontend_embeds=None) -> (last logits, cache);
    for enc-dec, step(params, src_embeds) -> cache."""
    if cfg.family == "encdec":
        def step(params, src_embeds):
            return encdec.prefill(params, src_embeds, cfg, src_embeds.shape[0],
                                  max_len)
    else:
        def step(params, tokens, frontend_embeds=None):
            return lm.prefill(params, tokens, cfg, max_len,
                              frontend_embeds=frontend_embeds)
    return step


def greedy_decode_loop(params, cfg: ArchConfig, cache, first_token: torch.Tensor,
                       start_pos: int, n_steps: int):
    """Greedy decoding: ``n_steps`` decode steps from ``first_token`` (B, 1)
    at ``start_pos``, each feeding back the argmax (the first maximum, as
    ``jnp.argmax``).  Returns (tokens (B, n_steps), cache).

    Example (CPU)::

        cfg = configs.get("qwen1.5-0.5b-smoke")
        params = lm.init(cfg, torch.Generator().manual_seed(0))
        prompt = torch.randint(0, cfg.vocab, (2, 16))
        logits, cache = make_prefill_step(cfg, max_len=24)(params, prompt)
        first = logits[:, -1].argmax(-1, keepdim=True)
        tokens, cache = greedy_decode_loop(params, cfg, cache, first, 16, 8)
    """
    step = make_decode_step(cfg)
    token, out = first_token, []
    for i in range(n_steps):
        logits, cache = step(params, token, cache, start_pos + i)
        token = torch.argmax(logits[:, -1], dim=-1).to(token.dtype)[:, None]
        out.append(token[:, 0])
    if not out:
        return first_token.new_zeros((first_token.shape[0], 0)), cache
    return torch.stack(out, dim=1), cache


# ---------------------------------------------------------------------------
# MPC private inference (ResNet, the paper's workload)
# ---------------------------------------------------------------------------

def make_mpc_serve_step(rcfg: ResNetConfig, hb: Optional[HBConfig],
                        cone: bool = False, mesh=None,
                        party_axis: str = "party",
                        data_axis: Optional[str] = None, *,
                        device: Device = None):
    """step(params, x, triples, key) -> x_out logits shares.

    ``x``: the int64 input shares, shape (2, B, 3, H, W).  A thin wrapper
    over ``api``: the plan replay and triple pool come from
    ``PrivateModel.serve_step``.  With ``mesh=None`` the party dimension is
    materialised (the session's comm); with a mesh carrying a party axis
    the step is mesh-native, every fused protocol round one exchange on the
    mesh (see ``PrivateModel.serve_step``).  ``data_axis`` also splits the
    request batch over that mesh axis; ``triples`` must then be
    ``beaver.shard_pool(pool, mesh.shape[data_axis])``.  ``device`` is the
    session's (default ``cuda``).
    """
    model = api.compile(None, None, rcfg,
                        api.Plan.from_hb(resnet.hb_or_exact(hb, rcfg), cone=cone,
                                         name=rcfg.name),
                        api.Session(device=device))
    return model.serve_step(mesh, party_axis=party_axis, data_axis=data_axis)


def make_inference_engine(params, rcfg: ResNetConfig,
                          hb: Optional[HBConfig] = None, *,
                          example_batch: int = 2, cone: bool = False,
                          session=None, policy=None, **engine_kw):
    """Request-level serving engine over a ResNet config (the paper's
    workload), ``serve.InferenceEngine``.

    Traces the plan at ``example_batch`` (other request shapes are traced
    on demand into the engine's plan cache) and binds the HummingBird
    assignment ``hb`` (exact 64-bit when None).

    Example::

        engine = make_inference_engine(params, RESNET_SMOKE, hb,
                                       session=api.Session(key=0, device="cpu"))
        fut = engine.submit("tenant-a", x)
        logits = fut.result().reveal()
    """
    from ..serve import InferenceEngine

    def afn(p, v, relu_fn=None):
        return resnet.apply(p, v, rcfg, relu_fn=relu_fn)

    plan = resnet.trace(params, rcfg, example_batch, cone=cone)
    if hb is not None:
        plan = plan.with_hb(HBConfig(hb.layers, plan.group_elements))
    return InferenceEngine(afn, params, rcfg, plan, session, policy=policy,
                           **engine_kw)


# ---------------------------------------------------------------------------
# The MPC dry run's inputs: shapes, specs and per-rank blocks, no allocation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputSpec:
    """One input of the mesh-native MPC step: its global shape and dtype,
    its spec (a mesh axis name or None per dim, as a ``PartitionSpec``)
    and the block one rank holds, as ``Mesh.local_block`` cuts it."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Tuple[Optional[str], ...]
    block: Tuple[int, ...]

    @property
    def block_bytes(self) -> int:
        return math.prod(self.block) * self.dtype.itemsize


def _axis_sizes(mesh) -> Dict[str, int]:
    """A port ``Mesh``'s axis sizes (its ``shape``), or a mapping of them."""
    return dict(mesh.shape) if hasattr(mesh, "axis_names") else dict(mesh)


def _input_spec(shape, dtype: torch.dtype, spec, sizes: Dict[str, int]) -> InputSpec:
    shape = tuple(int(d) for d in shape)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    block = []
    for d, axis in zip(shape, spec):
        n = sizes[axis] if axis is not None else 1
        if d % n:
            raise ValueError(f"dim {d} of {shape} does not split into {n} blocks "
                             f"along {axis!r}")
        block.append(d // n)
    return InputSpec(shape, dtype, spec, tuple(block))


def _triple_pool_shardings(pool, mesh, party_axis: str):
    """Each pool leaf's ``InputSpec``: its party dim from
    ``beaver.pool_party_specs`` (leading for ``bin_init``, the arithmetic
    members and the cone's levels, second for the dense ``bin_levels``),
    the structural derivation the mesh ``serve_step`` reads too; nothing is
    guessed from a leaf's shape."""
    sizes = _axis_sizes(mesh)
    specs = beaver.pool_party_specs(pool, party_axis)
    return [None if b is None else beaver.map_bundle(
        lambda t, sp: _input_spec(t.shape, t.dtype, sp, sizes), b, s)
        for b, s in zip(pool, specs)]


def mpc_input_specs(rcfg: ResNetConfig, batch: int, mesh,
                    hb: Optional[HBConfig], cone: bool = False):
    """(params, x, triples, key) of the mesh-native MPC step at ``batch``,
    as ``InputSpec`` trees, computed on fake tensors (nothing allocated):
    the int64 input shares (2, B, 3, H, W) split over (party, data), the
    params and the key replicated, the plan's triple pool split over the
    party axis.  ``mesh``: a port ``Mesh`` or a mapping of axis sizes with
    a "party" (or "pod") axis and "data"."""
    sizes = _axis_sizes(mesh)
    party_axis = "party" if "party" in sizes else "pod"
    hw = rcfg.in_hw
    x = _input_spec((2, batch, 3, hw, hw), torch.int64, (party_axis, "data"), sizes)
    shapes = specs.shapes_of(lambda: resnet.init(rcfg, device="cpu"))
    params = tree_map(lambda leaf: _input_spec(leaf.shape, leaf.dtype, (), sizes), shapes)
    plan = resnet.trace(tree_map(lambda leaf: torch.empty(
        leaf.shape, dtype=leaf.dtype, device="meta"), shapes),
        rcfg, batch, hb=resnet.hb_or_exact(hb, rcfg), cone=cone)
    pool = beaver.gen_plan_triples(torch.zeros(2, dtype=torch.int64, device="meta"),
                                   plan.triple_specs(), cone=cone)
    triples = _triple_pool_shardings(pool, mesh, party_axis)
    key = _input_spec((2,), torch.int64, (), sizes)
    return params, x, triples, key
