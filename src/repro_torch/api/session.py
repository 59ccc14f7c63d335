"""Session: who talks to whom, with which randomness and which triples, on
which device (twin of the reference's ``api/session.py``).

A Session owns the party communicator (``SimComm`` or a counting /
coalescing wrapper), the PRNG stream protocol keys are drawn from, a
``beaver`` triple provider, and the device everything runs on.  The device
defaults to the GPU; a Session asked for CUDA on a machine without a card
raises rather than running elsewhere.
"""
from __future__ import annotations

from typing import Union

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
