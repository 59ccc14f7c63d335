"""Plan / Session / compile: one private-inference API over any registered
model (twin of the reference's ``repro.api``)."""
from ..core.hummingbird import HBConfig, HBLayer
from .compile import PrivateModel, compile, register_mpc_forward, resolve_mpc_forward
from .plan import (HIGHBW, LAN, NETWORKS, WAN, NetworkPreset, OpenCall, Plan,
                   ReluCall, trace_plan)
from .session import Session

#: serving-engine types re-exported lazily (PEP 562) so that ``api`` and
#: ``serve`` can import each other's submodules without a cycle:
#: ``api.InferenceEngine`` is ``serve.InferenceEngine``.
_SERVE_EXPORTS = ("InferenceEngine", "BatchPolicy", "BatchReport", "Request",
                  "RequestFuture")

__all__ = ["HIGHBW", "LAN", "NETWORKS", "WAN", "NetworkPreset", "OpenCall",
           "Plan", "ReluCall", "trace_plan", "Session", "compile", "PrivateModel",
           "register_mpc_forward", "resolve_mpc_forward", "HBConfig", "HBLayer",
           *_SERVE_EXPORTS]


def __getattr__(name: str):
    if name in _SERVE_EXPORTS:
        from ..serve import engine as _engine
        return getattr(_engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
