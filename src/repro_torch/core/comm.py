"""Party communicator: simulation and mesh backends plus counting,
coalescing and resilient wrappers (twins of ``SimComm``, ``MeshComm``,
``CountingComm``, ``CoalescingComm`` and ``ResilientComm`` in the
reference's ``core/comm.py``).

Protocol code works on tensors with a leading party dimension.  A payload
is one tensor, of one of two dtypes:

- int32 packed words, 4 bytes per word;
- int64 ring elements, which go on the wire as their low 32-bit words then
  their high words, exactly as the reference's ``Ring64(lo, hi)`` pytree
  flattens; 8 bytes per element.

So ``CoalescingComm.flush`` builds the same (P, total_words) buffer as the
reference, word for word, and the byte counters agree.

``ResilientComm`` frames that buffer as the reference does (a round
sequence column, then a per-party checksum column), verifies every
received frame, and heals drops, stalls and corruption by idempotent
re-send with bounded exponential backoff; only an exhausted retry budget
raises the typed ``errors`` failure.  Framing and verification run on the
buffer's device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from .. import errors
from .schedule import FRAME_WORDS


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


@dataclasses.dataclass(frozen=True)
class Collective:
    """One census entry: ``count`` exchanges of ``bytes`` per-party
    one-direction payload bytes (the reference's HLO census entry)."""

    count: int
    bytes: int


class MeshComm:
    """Mesh backend: the party dimension split over a mesh axis of ranks
    (``launch.mesh.Mesh``), twin of the reference's ``MeshComm``.

    The global party dimension (size ``n_parties`` = 2) is split over the
    mesh axis ``axis_name`` of size ``axis_size``, so this rank holds a
    local party dimension of ``n_parties // axis_size`` rows:

    - ``axis_size == 2`` (one rank per non-colluding server): local party
      dim 1; ``swap`` is ONE ``dist.batch_isend_irecv`` pair (send this
      rank's rows, receive the peer's) on the mesh's party subgroup.  On a
      ``gloo`` mesh the payload is staged through host memory (pinned for
      a CUDA payload), explicitly; on ``nccl`` the device tensor goes as
      it is;
    - ``axis_size == 1`` (``make_mpc_smoke_mesh``): both parties in this
      process (local party dim 2); the exchange is the local flip.

    ``census`` holds one ``Collective(1, bytes)`` per exchange handed to
    ``swap``, local or not (the port's counterpart of the reference's HLO
    collective census), so ``CoalescingComm`` over a ``MeshComm`` base must
    leave exactly one entry per fused round, with the round's bytes.  A
    captured replay (``runtime/loop.py``) holds its local flips in its
    graph and hands this comm none.
    """

    n_parties = 2

    def __init__(self, axis_name: str = "party", axis_size: int = 2, mesh=None):
        if self.n_parties % axis_size:
            raise ValueError(
                f"party axis size {axis_size} must divide {self.n_parties}")
        if axis_size > 1 and mesh is None:
            raise ValueError(f"a party axis of size {axis_size} needs its mesh")
        self.axis_name = axis_name
        self.axis_size = axis_size
        self.local_parties = self.n_parties // axis_size
        self.mesh = mesh
        self.party = mesh.coords[axis_name] if axis_size > 1 else 0
        self.census: List[Collective] = []

    def swap(self, x: torch.Tensor) -> torch.Tensor:
        """Global party flip: local party-dim flip, or the exchange with
        the peer rank across the mesh."""
        if x.shape[0] != self.local_parties:
            raise ValueError(f"payload of shape {tuple(x.shape)}: this rank holds "
                             f"{self.local_parties} party rows")
        out = torch.flip(x, dims=(0,)) if self.axis_size == 1 else self._exchange(x)
        self.census.append(Collective(1, payload_bytes(x)))
        return out

    def _exchange(self, x: torch.Tensor) -> torch.Tensor:
        mesh = self.mesh
        peer = mesh.rank_at(**{self.axis_name: 1 - self.party})
        group = mesh.groups[self.axis_name]
        stage = mesh.backend == "gloo" and x.device.type != "cpu"
        if stage:
            tx = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            tx.copy_(x)
        else:
            tx = x.contiguous()
        rx = torch.empty_like(tx)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, tx, peer, group),
                                       dist.P2POp(dist.irecv, rx, peer, group)])
        for req in reqs:
            req.wait()
        return rx.to(x.device) if stage else rx

    def party_is(self, p: int, template: torch.Tensor) -> torch.Tensor:
        if self.local_parties == self.n_parties:
            return SimComm.party_is(self, p, template)
        return torch.full((1,) * max(1, template.ndim), p == self.party,
                          dtype=torch.bool, device=template.device)

    def party_slice(self, full: torch.Tensor) -> torch.Tensor:
        """Local party rows of a full-party-dim (n_parties, ...) tensor."""
        if self.local_parties == self.n_parties:
            return full
        return full[self.party:self.party + 1]


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


# ---------------------------------------------------------------------------
# Resilient transport: framing + detection + retry/backoff
# ---------------------------------------------------------------------------

_CKSUM_MULT = 2654435761                     # Knuth's multiplicative hash
_SEQ_MIX = 0x9E3779B1
_U32_MASK = 0xFFFFFFFF


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as their int32 bit patterns."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _seq_word(seq: int) -> int:
    """The sequence column's int32 value: ``seq`` mod 2^32, as a bit pattern."""
    v = seq & _U32_MASK
    return v - (1 << 32) if v >= 1 << 31 else v


def frame_checksum(words: torch.Tensor, seq: int) -> torch.Tensor:
    """Per-party checksum of a (P, n) int32 wire buffer under round seq,
    as a (P,) int32 bit pattern, equal bit for bit to the reference's
    numpy ``frame_checksum`` (computed here in int64 masked to 32 bits, on
    the buffer's device).

    Position-weighted multiplicative mix: a flip of any single word (or a
    swap of two words) changes the sum by a nonzero odd multiple mod 2^32,
    so single-word corruption is always detected; ``seq`` is folded in so
    a stale round's frame can never verify against the current round.
    """
    w = words.to(torch.int64) & _U32_MASK
    idx = (torch.arange(w.shape[-1], dtype=torch.int64, device=w.device)
           * _CKSUM_MULT) & _U32_MASK
    acc = (((w ^ idx) * _CKSUM_MULT) & _U32_MASK).sum(dim=-1) & _U32_MASK
    return _as_int32(acc ^ ((int(seq) * _SEQ_MIX) & _U32_MASK))


class ResilientComm:
    """Framed, self-healing transport wrapper over any eager base backend.

    Every ``swap`` flattens its payload into one (P, n) int32 word buffer
    (``payload_words``) and appends ``FRAME_WORDS`` framing words, the
    round sequence number and a per-party checksum, before exchanging.  On
    receipt the frame is verified: a sequence mismatch means the parties
    desynced (a duplicated or stale delivery), a checksum mismatch means
    payload corruption; either triggers an idempotent re-send of the SAME
    framed buffer.  An attempt that raises a transient comm fault (injected
    by ``core.faults.FaultInjectingComm``, a socket timeout under
    ``transport.SocketComm``) or takes longer than ``timeout_s`` is retried
    too, with bounded exponential backoff between attempts.  Only when the
    per-round retry budget is exhausted does the typed error
    (``errors.CommTimeout`` / ``PayloadCorrupted`` / ``PartyCrashed``)
    propagate.

    Composition: ``CoalescingComm(ResilientComm(base))``: coalescing above,
    so the whole fused round is ONE framed exchange and re-sends never add
    protocol rounds.  ``Schedule.framed()`` prices the framing, so
    ``round_bytes`` here equal the framed schedule exactly; failed
    attempts accumulate in ``resent_bytes``, never in ``round_bytes``.

    Counters: ``n_rounds``/``round_bytes``/``bytes_tx`` (successful framed
    rounds), ``retries`` (failed attempts), ``recovered`` (rounds that
    needed at least one retry), ``resent_bytes``, and ``faults_detected``
    by kind ("timeout", "corrupt", "crash").
    """

    def __init__(self, base=None, *, max_retries: int = 3,
                 timeout_s: Optional[float] = None,
                 backoff_s: float = 0.0, backoff_cap_s: float = 1.0):
        self.base = base if base is not None else SimComm()
        self.n_parties = self.base.n_parties
        self.max_retries = max_retries
        self.timeout_s = timeout_s
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        self.reset()

    def reset(self) -> None:
        self._seq = 0
        self.n_rounds = 0
        self.round_bytes: List[int] = []
        self.retries = 0
        self.recovered = 0
        self.resent_bytes = 0
        self.faults_detected: Dict[str, int] = {
            "timeout": 0, "corrupt": 0, "crash": 0}

    @property
    def bytes_tx(self) -> int:
        return sum(self.round_bytes)

    # -- framing ---------------------------------------------------------------
    def _frame(self, buf: torch.Tensor) -> torch.Tensor:
        framed = torch.empty((buf.shape[0], buf.shape[1] + FRAME_WORDS),
                             dtype=torch.int32, device=buf.device)
        framed[:, :-FRAME_WORDS] = buf
        framed[:, -2] = _seq_word(self._seq)
        framed[:, -1] = frame_checksum(buf, self._seq)
        return framed

    def _verify(self, opened: torch.Tensor) -> torch.Tensor:
        """Checks the received frame; raises typed errors on mismatch and
        returns the received payload words (a view) on success."""
        payload, seq_col, cksum_col = (opened[:, :-FRAME_WORDS], opened[:, -2],
                                       opened[:, -1])
        if not bool((seq_col == _seq_word(self._seq)).all()):
            got = sorted(set(int(s) & _U32_MASK for s in seq_col.tolist()))
            raise errors.PayloadCorrupted(
                f"round desync: expected seq {self._seq}, received {got}")
        ok = cksum_col == frame_checksum(payload, self._seq)
        if not bool(ok.all()):
            bad = [p for p, good in enumerate(ok.tolist()) if not good]
            raise errors.PayloadCorrupted(
                f"checksum mismatch on round {self._seq} "
                f"(party rows {bad}): payload corrupted in flight")
        return payload

    # -- the exchange ----------------------------------------------------------
    def swap(self, x: torch.Tensor) -> torch.Tensor:
        words = payload_words(x)
        buf = torch.cat(words, dim=1) if len(words) > 1 else words[0]
        framed = self._frame(buf)
        frame_cost = payload_bytes(framed)
        attempt = 0
        while True:
            t0 = time.monotonic()
            try:
                opened = self.base.swap(framed)
                if (self.timeout_s is not None
                        and time.monotonic() - t0 > self.timeout_s):
                    raise errors.CommTimeout(
                        f"round {self._seq}: exchange stalled past "
                        f"{self.timeout_s}s")
                payload = self._verify(opened)
                break
            except errors.CommError as e:
                kind = ("crash" if isinstance(e, errors.PartyCrashed) else
                        "corrupt" if isinstance(e, errors.PayloadCorrupted)
                        else "timeout")
                self.faults_detected[kind] += 1
                self.resent_bytes += frame_cost
                # A crashed peer cannot be healed by a re-send: recovery
                # is restart + journal resume, owned by the layer above.
                if isinstance(e, errors.PartyCrashed):
                    raise
                if attempt >= self.max_retries:
                    raise
                self.retries += 1
                attempt += 1
                if self.backoff_s > 0:
                    time.sleep(min(self.backoff_s * 2 ** (attempt - 1),
                                   self.backoff_cap_s))
        self.n_rounds += 1
        self.round_bytes.append(frame_cost)
        if attempt:
            self.recovered += 1
        self._seq += 1
        return words_payload(payload, x)

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


def find_resilient(comm) -> Optional["ResilientComm"]:
    """The ``ResilientComm`` inside a wrapper stack, if any (the serving
    engine reads its recovery counters per batch)."""
    return find_comm(comm, ResilientComm)
