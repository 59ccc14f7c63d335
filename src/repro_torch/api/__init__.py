"""Plan / Session / compile: one private-inference API over any registered
model (twin of the reference's ``repro.api``)."""
from ..core.hummingbird import HBConfig, HBLayer
from .compile import PrivateModel, compile, register_mpc_forward, resolve_mpc_forward
from .plan import (HIGHBW, LAN, NETWORKS, WAN, NetworkPreset, OpenCall, Plan,
                   ReluCall, trace_plan)
from .session import Session

__all__ = ["HIGHBW", "LAN", "NETWORKS", "WAN", "NetworkPreset", "OpenCall",
           "Plan", "ReluCall", "trace_plan", "Session", "compile", "PrivateModel",
           "register_mpc_forward", "resolve_mpc_forward", "HBConfig", "HBLayer"]
