"""Deterministic fault injection + round journaling: chaos as an input (twin
of the reference's ``core/faults.py``).

``FaultInjectingComm`` is the chaos counterpart of ``CountingComm``: a
transparent wrapper over any eager base backend that realizes a seeded,
round-addressable ``FaultPlan`` (transient drops, stalls, payload
bit-corruption, and party crashes) exactly where the plan says, and
nowhere else.  Both the protocol and the plan are deterministic, so every
chaos run is reproducible bit for bit, and recovered executions equal
fault-free ones exactly.  ``FaultPlan.seeded`` draws from numpy's
``default_rng`` as the reference does: one seed gives the same events in
both packages.

Round addressing: ``FaultEvent.round`` indexes the comm's *clean-swap*
counter: the cursor advances only when a round delivers uncorrupted and
unfaulted, so a retried round consumes its one-shot event on the faulted
attempt and the re-send passes.  In a serving run this counter is the
global fused-round timeline (the one ``core.schedule`` predicts), not a
per-batch index.  A ``crash`` is persistent: every later swap raises
``errors.PartyCrashed`` until ``restart()`` is called (the serving
engine's ``on_party_crash`` hook, or the resume path below).

``RoundJournal``/``JournaledComm`` implement round-level resume.  The
journal records each completed round's opened wire words as host (numpy)
arrays; after a crash, a restarted party re-runs the SAME deterministic
round generators with the journal mounted: recorded rounds replay from the
journal without touching the wire, live execution resumes at the first
unjournaled round, and the final shares are bit-identical to an
uninterrupted run.  Journals persist through ``checkpoint/store.py``'s
torn-write-safe idiom (tmp dir + COMMITTED sentinel + atomic rename), so a
crash *during* a snapshot can never leave a half-written journal.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import errors
from ..checkpoint import store
from .comm import SimComm, payload_words, words_payload

KINDS = ("drop", "stall", "corrupt", "crash")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``round`` indexes the clean-swap counter of
    the ``FaultInjectingComm`` realizing it (see module docstring)."""

    round: int
    kind: str                   # one of KINDS
    delay_s: float = 0.0        # stall only: sleep before timing out
    word: int = 0               # corrupt only: flat word index (mod size)
    bit: int = 0                # corrupt only: which bit to flip

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")


@dataclass(frozen=True)
class FaultPlan:
    """A deterministic chaos schedule: a tuple of one-shot events (crash
    excepted: it persists until ``restart()``)."""

    events: Tuple[FaultEvent, ...] = ()

    @classmethod
    def seeded(cls, seed: int, n_rounds: int, *, drops: int = 1,
               corrupts: int = 1, stalls: int = 0, stall_s: float = 0.0,
               crash_round: Optional[int] = None) -> "FaultPlan":
        """A reproducible plan: ``drops + corrupts + stalls`` transient
        events on distinct rounds drawn without replacement from
        ``range(n_rounds)``, plus an optional persistent crash."""
        rng = np.random.default_rng(seed)
        kinds = (["drop"] * drops + ["corrupt"] * corrupts
                 + ["stall"] * stalls)
        rng.shuffle(kinds)
        n = min(len(kinds), max(n_rounds, 0))
        rounds = (sorted(int(r) for r in
                         rng.choice(n_rounds, size=n, replace=False))
                  if n else [])
        events = [
            FaultEvent(round=r, kind=kind,
                       delay_s=stall_s if kind == "stall" else 0.0,
                       word=int(rng.integers(0, 2**31)),
                       bit=int(rng.integers(0, 32)))
            for r, kind in zip(rounds, kinds)]
        if crash_round is not None:
            events.append(FaultEvent(round=int(crash_round), kind="crash"))
        return cls(tuple(sorted(events, key=lambda e: e.round)))

    def events_at(self, r: int) -> Tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.round == r)

    def count(self, kind: str) -> int:
        return sum(1 for e in self.events if e.kind == kind)

    @property
    def n_transient(self) -> int:
        """Events a ``ResilientComm`` retry absorbs (everything but crash)."""
        return sum(1 for e in self.events if e.kind != "crash")


def _flip_bit(opened: torch.Tensor, ev: FaultEvent) -> torch.Tensor:
    """The delivered payload with one bit flipped in its first word leaf
    (the int32 words, or an int64 payload's low words), at the reference's
    flat position: in-flight corruption, deterministic position."""
    leaves = [w.clone() for w in payload_words(opened)]
    flat = leaves[0].view(-1)
    i = ev.word % flat.numel()
    bit = 1 << (ev.bit % 32)
    flat[i] ^= bit - (1 << 32) if bit >= 1 << 31 else bit
    return words_payload(torch.cat(leaves, dim=1), opened)


class FaultInjectingComm:
    """Realizes a ``FaultPlan`` over any eager base backend.

    drop/stall  -> raise ``errors.CommTimeout`` (stall sleeps first, so a
                   ``ResilientComm`` backoff schedule is actually paced)
    corrupt     -> deliver the exchange with one bit flipped
    crash       -> raise ``errors.PartyCrashed`` on this and EVERY later
                   swap until ``restart()``

    The clean-round cursor (``self.round``) advances only on unfaulted
    delivery, so one-shot events are consumed by the faulted attempt and
    the idempotent re-send goes through.  ``injected`` counts events by
    kind as they are realized.
    """

    def __init__(self, plan: FaultPlan, base=None):
        self.base = base if base is not None else SimComm()
        self.plan = plan
        self.n_parties = self.base.n_parties
        self.round = 0
        self.restarts = 0
        self.injected: Dict[str, int] = {k: 0 for k in KINDS}
        self._crashed: Optional[int] = None
        self._consumed: set = set()

    def restart(self) -> None:
        """Revive a crashed party (models process restart).  Consumed
        events stay consumed; the round cursor keeps its position on the
        global timeline."""
        self._crashed = None
        self.restarts += 1

    def swap(self, x: torch.Tensor) -> torch.Tensor:
        if self._crashed is not None:
            raise errors.PartyCrashed(
                f"party down since round {self._crashed}; restart() first")
        corrupt: Optional[FaultEvent] = None
        for idx, ev in enumerate(self.plan.events):
            if ev.round != self.round or idx in self._consumed:
                continue
            self._consumed.add(idx)
            self.injected[ev.kind] += 1
            if ev.kind == "crash":
                self._crashed = self.round
                raise errors.PartyCrashed(
                    f"injected crash at round {self.round}")
            if ev.kind == "stall":
                if ev.delay_s > 0:
                    time.sleep(ev.delay_s)
                raise errors.CommTimeout(
                    f"injected stall at round {self.round}")
            if ev.kind == "drop":
                raise errors.CommTimeout(
                    f"injected drop at round {self.round}")
            corrupt = ev                     # deliver, then damage it
            break
        opened = self.base.swap(x)
        if corrupt is not None:
            return _flip_bit(opened, corrupt)    # cursor does NOT advance
        self.round += 1
        return opened

    def party_is(self, p: int, template: torch.Tensor) -> torch.Tensor:
        return self.base.party_is(p, template)

    def party_slice(self, full: torch.Tensor) -> torch.Tensor:
        return self.base.party_slice(full)


# ---------------------------------------------------------------------------
# Round-level resume: journal + replaying comm
# ---------------------------------------------------------------------------

class RoundJournal:
    """Opened wire payloads of completed rounds, in order: each round's
    word leaves (``comm.payload_words``) as host uint32 arrays, the
    reference's leaf dtype.

    Persistence rides the checkpoint store's atomic-commit idiom: a
    snapshot either lands whole (COMMITTED sentinel present) or not at
    all, so resuming from a torn snapshot is impossible.
    """

    def __init__(self):
        self.rounds: List[List[np.ndarray]] = []

    def __len__(self) -> int:
        return len(self.rounds)

    def record(self, leaves) -> None:
        self.rounds.append([
            leaf.detach().cpu().numpy().view(np.uint32)
            if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
            for leaf in leaves])

    def truncate(self, n_rounds: int) -> None:
        """Drop every round past ``n_rounds``: the resume negotiation.
        After an abrupt kill the two parties' journals may differ by the
        in-flight round, so both truncate to ``min(len_a, len_b)``
        (exchanged in the transport handshake) and resume live execution
        from the same round barrier."""
        del self.rounds[int(n_rounds):]

    def save(self, ckpt_dir: str) -> None:
        flat = [a for rnd in self.rounds for a in rnd]
        store.save(ckpt_dir, step=len(self.rounds), tree=flat,
                   extra={"round_lens": [len(r) for r in self.rounds]})

    @classmethod
    def load(cls, ckpt_dir: str) -> "RoundJournal":
        manifest = store.load_manifest(ckpt_dir)
        lens = manifest["extra"]["round_lens"]
        template = [np.zeros(1, np.uint32)] * sum(lens)
        flat, _ = store.restore(ckpt_dir, template)
        j = cls()
        it = iter(flat)
        for n in lens:
            j.rounds.append([np.asarray(next(it)) for _ in range(n)])
        return j


class JournaledComm:
    """Replay-through-journal transport wrapper.

    Rounds already in the mounted journal are served from the record
    without touching the wire (``replayed`` counts them); live rounds go
    to ``base`` and are recorded on success.  Mount it ABOVE
    ``ResilientComm`` so only verified payloads are journaled, and BELOW
    ``CoalescingComm`` so one journal entry is one fused round.

    With ``snapshot_dir``, the journal is persisted (atomically) every
    ``snapshot_every`` live rounds: the continuous-checkpoint mode a
    deployed party host runs in, so a kill at ANY round loses at most
    ``snapshot_every - 1`` rounds of journal (``launch/party_host.py``).
    """

    def __init__(self, base=None, journal: Optional[RoundJournal] = None,
                 *, snapshot_dir: Optional[str] = None,
                 snapshot_every: int = 1):
        self.base = base if base is not None else SimComm()
        self.journal = journal if journal is not None else RoundJournal()
        self.n_parties = self.base.n_parties
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = max(1, int(snapshot_every))
        self.cursor = 0
        self.replayed = 0

    def swap(self, x: torch.Tensor) -> torch.Tensor:
        n_leaves = len(payload_words(x))
        if self.cursor < len(self.journal):
            rec = self.journal.rounds[self.cursor]
            if len(rec) != n_leaves:
                raise errors.PayloadCorrupted(
                    f"journal round {self.cursor} holds {len(rec)} leaves "
                    f"but the payload has {n_leaves}: journal does not "
                    f"match this execution")
            self.cursor += 1
            self.replayed += 1
            words = np.concatenate(
                [np.asarray(a, np.uint32).reshape(x.shape[0], -1) for a in rec],
                axis=1)
            return words_payload(
                torch.from_numpy(words.view(np.int32)).to(x.device), x)
        opened = self.base.swap(x)
        self.journal.record(payload_words(opened))
        self.cursor += 1
        if (self.snapshot_dir is not None
                and self.cursor % self.snapshot_every == 0):
            self.snapshot(self.snapshot_dir)
        return opened

    def snapshot(self, ckpt_dir: str) -> None:
        """Persist the journal at the current round barrier (atomic)."""
        self.journal.save(ckpt_dir)

    def party_is(self, p: int, template: torch.Tensor) -> torch.Tensor:
        return self.base.party_is(p, template)

    def party_slice(self, full: torch.Tensor) -> torch.Tensor:
        return self.base.party_slice(full)
