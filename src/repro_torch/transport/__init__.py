"""Real two-party deployment: each party is its own OS process (twin of the
reference's ``repro.transport``).

``SocketComm`` implements the ``Comm`` interface over one TCP connection
(local party dimension 1), speaking the reference's HBTP wire protocol
byte for byte: a handshake that refuses mismatched sessions or plans,
typed timeout/crash failures the resilience stack heals, payload-exact
byte accounting against ``core.schedule``, and optional link shaping
(injected RTT + bandwidth cap) so LAN/WAN latency predictions can be
checked against measured wall-clock.

Compose via ``api.Session.connect`` (socket -> ResilientComm ->
JournaledComm), run a party process with ``python -m
repro_torch.launch.party_host``, and serve requests through
``serve.Frontend`` + ``EngineLink`` (leader) against a ``serve_follower``
loop (follower).
"""
from .socket import (HEADER, LinkShaper, SocketComm, free_port,
                     parse_address)
from .job import load_job, load_party, pool_treedef, resolve_config, \
    write_job
from .engine_link import EngineLink, serve_follower, tenant_provider_factory

__all__ = [
    "HEADER", "LinkShaper", "SocketComm", "free_port", "parse_address",
    "load_job", "load_party", "pool_treedef", "resolve_config",
    "write_job", "EngineLink", "serve_follower", "tenant_provider_factory",
]
