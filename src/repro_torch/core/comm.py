"""Party communicator: simulation backend plus counting and coalescing
wrappers (twins of ``SimComm``, ``CountingComm`` and ``CoalescingComm`` in
the reference's ``core/comm.py``).

Protocol code works on tensors with a leading party dimension.  A payload
is one tensor, of one of two dtypes:

- int32 packed words, 4 bytes per word;
- int64 ring elements, which go on the wire as their low 32-bit words then
  their high words, exactly as the reference's ``Ring64(lo, hi)`` pytree
  flattens; 8 bytes per element.

So ``CoalescingComm.flush`` builds the same (P, total_words) buffer as the
reference, word for word, and the byte counters agree.
"""
from __future__ import annotations

from typing import List, Optional

import torch


def payload_bytes(t: torch.Tensor) -> int:
    """Per-party one-direction wire bytes of a payload (party dim leading)."""
    return (t.numel() // max(1, t.shape[0])) * t.element_size()


def payload_words(t: torch.Tensor) -> List[torch.Tensor]:
    """A payload as (P, n) int32 wire words: packed words as they are, ring
    elements as all low words then all high words."""
    if t.dtype == torch.int32:
        return [t.reshape(t.shape[0], -1)]
    if t.dtype == torch.int64:
        limbs = t.reshape(t.shape[0], -1).view(torch.int32)
        return [limbs[:, 0::2], limbs[:, 1::2]]
    raise TypeError(f"payloads must be int32 words or int64 ring values, got {t.dtype}")


def words_payload(words: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Inverse of ``payload_words`` on a (P, n) or (P, 2n) word slice."""
    if like.dtype == torch.int32:
        return words.reshape(like.shape)
    n = like.numel() // like.shape[0]
    limbs = torch.stack([words[:, :n], words[:, n:]], dim=-1)
    return limbs.view(torch.int64).reshape(like.shape)


class SimComm:
    """Single-host simulation backend. Party dim is axis 0 with size 2."""

    n_parties = 2

    def swap(self, x: torch.Tensor) -> torch.Tensor:
        """Each party receives the other party's tensor (one exchange)."""
        return torch.flip(x, dims=(0,))

    def party_is(self, p: int, template: torch.Tensor) -> torch.Tensor:
        """Boolean mask, True on party p, broadcastable against template."""
        idx = torch.arange(2, device=template.device)
        return idx.reshape((2,) + (1,) * (template.ndim - 1)) == p

    def party_slice(self, full: torch.Tensor) -> torch.Tensor:
        """Each party's rows of a full-party-dim array: all of them here."""
        return full


class CountingComm:
    """Transparent wrapper counting rounds (= ``swap`` calls) and bytes."""

    def __init__(self, base=None):
        self.base = base or SimComm()
        self.n_parties = self.base.n_parties
        self.reset()

    def reset(self) -> None:
        self.n_swaps = 0
        self.round_bytes: List[int] = []

    @property
    def bytes_tx(self) -> int:
        return sum(self.round_bytes)

    def swap(self, x):
        self.n_swaps += 1
        self.round_bytes.append(payload_bytes(x))
        return self.base.swap(x)

    def party_is(self, p: int, template: torch.Tensor) -> torch.Tensor:
        return self.base.party_is(p, template)

    def party_slice(self, full: torch.Tensor) -> torch.Tensor:
        return self.base.party_slice(full)


class CoalescingComm:
    """Deferred-exchange wrapper: one flattened ``swap`` per round.

    Protocol code enqueues the current round's payloads and receives
    integer handles; ``flush`` concatenates every payload's wire words into
    one (P, total_words) int32 buffer, fires ONE exchange on the base
    backend, and returns each handle's payload in its own shape and dtype.
    Counters: ``n_rounds``, ``round_bytes``, ``bytes_tx``, ``round_parts``
    (payloads per flush), as predicted by ``core.schedule``.
    """

    def __init__(self, base=None):
        self.base = base or SimComm()
        self.n_parties = self.base.n_parties
        self._queue: List[torch.Tensor] = []
        self.n_rounds = 0
        self.round_bytes: List[int] = []
        self.round_parts: List[int] = []

    @property
    def bytes_tx(self) -> int:
        return sum(self.round_bytes)

    def enqueue(self, payload: torch.Tensor) -> int:
        """Defer a payload to the current round; returns its handle."""
        if payload.dtype not in (torch.int32, torch.int64):
            raise TypeError("CoalescingComm payloads must be int32 words or "
                            f"int64 ring values, got {payload.dtype}")
        self._queue.append(payload)
        return len(self._queue) - 1

    def flush(self) -> List[torch.Tensor]:
        """Fire the round: one flattened swap; returns payloads by handle."""
        if not self._queue:
            return []
        queue, self._queue = self._queue, []
        flat = [w for payload in queue for w in payload_words(payload)]
        buf = torch.cat(flat, dim=1) if len(flat) > 1 else flat[0].contiguous()
        self.n_rounds += 1
        self.round_bytes.append(payload_bytes(buf))
        self.round_parts.append(len(queue))
        opened = self.base.swap(buf)
        results = []
        off = 0
        for payload in queue:
            n = payload_bytes(payload) // 4
            results.append(words_payload(opened[:, off:off + n], payload))
            off += n
        return results

    def swap(self, x):
        """Immediate exchange (enqueue + flush): still one round."""
        h = self.enqueue(x)
        return self.flush()[h]

    def replay_counters(self, n_rounds: int, round_bytes: List[int],
                        round_parts: List[int]) -> None:
        """Merge another CoalescingComm's recorded timeline into this one.
        The captured replay (``api/compile.py``) records onto a private
        comm whose counters fill once, during the capture; each replay
        merges them into the caller's comm, so accounting is unchanged."""
        self.n_rounds += n_rounds
        self.round_bytes.extend(round_bytes)
        self.round_parts.extend(round_parts)

    def party_is(self, p: int, template: torch.Tensor) -> torch.Tensor:
        return self.base.party_is(p, template)

    def party_slice(self, full: torch.Tensor) -> torch.Tensor:
        return self.base.party_slice(full)


def find_comm(comm, cls):
    """First wrapper of type ``cls`` in a comm stack (walks the ``.base``
    chain).  Lets callers reach a specific layer's counters without
    knowing how the stack was composed."""
    seen = set()
    while comm is not None and id(comm) not in seen:
        seen.add(id(comm))
        if isinstance(comm, cls):
            return comm
        comm = getattr(comm, "base", None)
    return None


def find_resilient(comm) -> Optional[object]:
    """The ``ResilientComm`` inside a wrapper stack, if any (the serving
    engine reads its recovery counters per batch).  The port has no
    ``ResilientComm`` yet (ROADMAP queue 1, item 6), so no stack holds one
    and this returns None; once it is ported this looks it up with
    ``find_comm``, as the reference does."""
    return None
