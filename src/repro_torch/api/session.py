"""Session: who talks to whom, with which randomness and which triples, on
which device (twin of the reference's ``api/session.py``).

A Session owns the party communicator (``SimComm`` or a counting /
coalescing wrapper), the PRNG stream protocol keys are drawn from, a
``beaver`` triple provider, and the device everything runs on.  The device
defaults to the GPU; a Session asked for CUDA on a machine without a card
raises rather than running elsewhere.

``resilient`` stacks the fault-tolerant transport over the comm;
``connect`` makes this process ONE party of a real two-process deployment
over TCP (``transport.SocketComm``), holding only its own share rows.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..core import beaver, comm as comm_lib, prng
from ..device import resolve as resolve_device


class Session:
    """Runtime context for private inference.

    - ``comm``: party communicator (default ``SimComm``; pass
      ``CoalescingComm`` or ``CountingComm`` to measure rounds and bytes);
    - ``key``: base PRNG key (or int seed); ``next_key()`` advances it;
    - ``provider``: triple provider (default ``InlineTTP``: triples derived
      inline from each call's key; ``offline`` switches to a pool made up
      front);
    - ``device``: where shares, keys and kernels live (default ``"cuda"``).

    Example::

        session = Session(key=0)                       # on the GPU
        cpu = Session(key=0, device="cpu")             # tests
        pooled = Session(key=0).offline(prng.PRNGKey(7), plan, requests=16)
    """

    def __init__(self, key: Union[int, torch.Tensor, None] = None, comm=None,
                 provider=None, device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)
        self.comm = comm if comm is not None else comm_lib.SimComm()
        self.provider = provider if provider is not None else beaver.InlineTTP()
        if key is None:
            key = 0
        self._key = (prng.PRNGKey(key, self.device) if isinstance(key, int)
                     else key.to(self.device))
        self._base_key = self._key

    def next_key(self) -> torch.Tensor:
        """One fresh request key off the session's PRNG stream."""
        self._key, k = prng.split(self._key)
        return k

    def request_key(self, request_id: int) -> torch.Tensor:
        """Per-request key ``fold_in(seed, request_id)``, independent of the
        ``next_key`` stream and of admission order."""
        return prng.fold_in(self._base_key, request_id)

    def offline(self, key: torch.Tensor, plan, requests: int = 1,
                streams: int = 1) -> "Session":
        """Switch this session to a triple pool generated now, on the
        session's device, for ``requests`` sequential replays of ``plan``,
        each over ``streams`` sibling streams (offline-TTP serving): the
        calls that follow only pop bundles."""
        self.provider = beaver.EagerTTP(key.to(self.device), plan.triple_specs(),
                                        cone=plan.cone, requests=requests,
                                        streams=streams)
        return self

    def resilient(self, *, max_retries: int = 3,
                  timeout_s: Optional[float] = None,
                  backoff_s: float = 0.0, backoff_cap_s: float = 1.0,
                  fault_plan=None, journal=None,
                  snapshot_dir: Optional[str] = None,
                  snapshot_every: int = 1) -> "Session":
        """Wrap this session's comm in the resilient transport stack:
        framed retry/backoff over the current backend, with optional
        deterministic fault injection below it and an optional round
        journal above it for crash/resume.

        Stack (bottom up):
        ``base -> FaultInjectingComm? -> ResilientComm -> JournaledComm?``;
        the engine / ``run_streams`` coalesce on top, so every fused round
        is ONE framed exchange and re-sends never add rounds.

        Example::

            plan = faults.FaultPlan.seeded(7, n_rounds=40)
            session = Session(key=0).resilient(fault_plan=plan)
        """
        from ..core import faults as faults_lib
        comm = self.comm
        if fault_plan is not None:
            comm = faults_lib.FaultInjectingComm(fault_plan, comm)
        comm = comm_lib.ResilientComm(comm, max_retries=max_retries,
                                      timeout_s=timeout_s,
                                      backoff_s=backoff_s,
                                      backoff_cap_s=backoff_cap_s)
        if journal is not None:
            comm = faults_lib.JournaledComm(comm, journal=journal,
                                            snapshot_dir=snapshot_dir,
                                            snapshot_every=snapshot_every)
        self.comm = comm
        return self

    @classmethod
    def connect(cls, party: int, *, listen=None, peer=None,
                key: Union[int, torch.Tensor, None] = None,
                provider=None, session_id: str = "", plan_digest: str = "",
                journal=None, snapshot_dir: Optional[str] = None,
                snapshot_every: int = 1, shaper=None,
                timeout_s: Optional[float] = 30.0, max_retries: int = 3,
                backoff_s: float = 0.01, backoff_cap_s: float = 0.5,
                handshake_timeout_s: float = 60.0,
                device: Union[str, torch.device, None] = None) -> "Session":
        """A real two-process deployment session: this process is ONE
        party, talking to its peer over TCP (``transport.SocketComm``).

        Exactly one of ``listen``/``peer`` names the link: ``listen``
        binds and accepts (conventionally party 0), ``peer`` dials with
        retry while the other process starts up.  The handshake
        cross-checks (party complement, ``session_id``, ``plan_digest``)
        and negotiates the journal resume round; the comm is then stacked
        ``SocketComm -> ResilientComm -> JournaledComm?`` so real timeouts
        heal via idempotent re-send and a restarted process resumes
        bit-identically from its journal (truncated here to the negotiated
        common prefix).  Local tensors carry a party dimension of 1; the
        provider must hold this party's slice of shared triples
        (``beaver.PartySlicedTTP``, a pool cut by ``slice_party_pool``).

        The socket transport is reachable afterwards as
        ``session.transport`` (wire-byte counters, ctrl channel).  The
        device check runs before any socket is opened.

        Example (one process per party)::

            s0 = Session.connect(0, listen=("127.0.0.1", 9000), key=7,
                                 session_id="demo", plan_digest=plan.digest())
            s1 = Session.connect(1, peer=("127.0.0.1", 9000), ...)
        """
        from ..transport import SocketComm
        device = resolve_device(device)
        journal_len = len(journal) if journal is not None else 0
        common = dict(party=party, session=session_id, plan=plan_digest,
                      journal_len=journal_len, shaper=shaper,
                      timeout_s=timeout_s)
        if (listen is None) == (peer is None):
            raise ValueError("pass exactly one of listen= / peer=")
        if listen is not None:
            sock = SocketComm.host(listen,
                                   accept_timeout_s=handshake_timeout_s,
                                   **common)
        else:
            sock = SocketComm.dial(peer,
                                   connect_timeout_s=handshake_timeout_s,
                                   **common)
        if journal is not None:
            journal.truncate(sock.negotiated["resume_round"])
        session = cls(key=key, comm=sock, provider=provider, device=device)
        session.resilient(max_retries=max_retries, backoff_s=backoff_s,
                          backoff_cap_s=backoff_cap_s, journal=journal,
                          snapshot_dir=snapshot_dir,
                          snapshot_every=snapshot_every)
        session.transport = sock
        return session
