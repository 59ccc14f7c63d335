"""MPC serving steps (the reference's ``launch/serve.py``: its private
ResNet step; the plaintext LM's prefill, decode and greedy loop belong to
the float model zoo and are not ported)."""
from __future__ import annotations

from typing import Optional

from .. import api
from ..configs.resnet import ResNetConfig
from ..core.hummingbird import HBConfig
from ..device import Device
from ..models import resnet


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
