"""Round-schedule simulator for the round-fused GMW engine.

The serving hot path is round-dominated, not byte-dominated (paper Fig.
3/4): a multi-group ReLU layer's wall-clock is set by the *fused* round
timeline ``run_streams`` executes, not by summed payload bytes.  This
module deterministically simulates that timeline for any set of
``(n_elements, width)`` protocol streams and is the single source of
truth the analytic layers delegate to (``costmodel.relu_cost`` /
``relu_many_cost``, ``api.Plan.cost/estimate``, the search engine's
``objective="latency"`` scoring, and the ``benchmarks/run.py --quick``
round-regression gate).

What is modelled, exactly as the engine executes it:

- **Per-stream timelines** (``stream_timeline``): one entry per
  communication round with its protocol phase and per-party one-direction
  payload bytes — A2B prep ("others"), initial AND + Kogge-Stone levels
  ("circuit", cone-pruned levels with an empty position set are skipped
  entirely), sign-bit B2A ("b2a") and the final Beaver mult ("mult").
- **Lockstep coalescing**: round r of the fused schedule carries the sum
  of every still-live stream's round-r payload in ONE exchange
  (``comm.CoalescingComm``); streams that finish early (narrower rings ->
  fewer adder levels) drop out, so later rounds shrink.
- **Cross-phase overlap**: a shallow group's B2A/mult rounds ride the
  same exchanges as a deeper group's adder levels — visible in each
  ``RoundSlot.phases``.
- **Auto-batching**: streams with an identical batch key (same
  ``(n_elements, k, m)`` in the engine) are merged into one stream on the
  batch dimension before coalescing, so they contribute one payload (and
  one fused kernel pass) per round instead of N, and repacking the
  combined element vector removes per-stream packing padding
  (``packed_words(sum n) <= sum packed_words(n)`` — bytes can only drop).
- **Culling / empties**: width-0 (k == m) and zero-element streams run
  zero rounds and contribute nothing.

Predictions are validated bit-exactly against ``CoalescingComm`` counters
in ``tests/test_schedule.py``.

This module is import-light on purpose (stdlib only): ``costmodel``,
``gmw`` and ``beaver`` all import it, so it must sit below every protocol
module.  ``cone_sets`` and ``n_levels`` live here for the same reason —
``gmw``/``beaver`` re-export them, which breaks the historical
costmodel -> gmw -> costmodel lazy-import cycle.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

WORD_BYTES = 4        # packed u32 wire words
RING_BYTES = 8        # one Z/2^64 element (two u32 limbs)

#: Resilient-transport framing: ``comm.ResilientComm`` appends a round
#: sequence word and a checksum word to every flushed round's flattened
#: uint32 buffer (see its docstring).  Declared here — the import-light
#: bottom of the stack — so the schedule can price the framed timeline
#: (``Schedule.framed``) and ``--check`` still equates measured and
#: predicted bytes when the resilient layer is in the stack.
FRAME_WORDS = 2
FRAME_BYTES = FRAME_WORDS * WORD_BYTES

#: Protocol phases in timeline order (names match the paper's Figure 3
#: categories and ``costmodel.CommCost.breakdown``).  ``Schedule.framed``
#: adds a fifth, synthetic "frame" phase on top of these.
PHASES = ("others", "circuit", "b2a", "mult")


def n_levels(w: int) -> int:
    """Kogge-Stone adder depth for a w-bit ring (0 for w <= 1)."""
    return max(0, math.ceil(math.log2(w))) if w > 1 else 0


def packed_words(n_elements: int) -> int:
    """u32 words per packed bitplane (mirror of ``shares.packed_words`` —
    kept local so this module stays stdlib-only)."""
    return (n_elements + 31) // 32


def cone_sets(w: int) -> Tuple[List[int], List[List[int]]]:
    """Backward cone of the single output G[w-2] through the Kogge-Stone
    levels (beyond-paper optimization: DReLU consumes only the MSB carry,
    so prefix positions outside the cone are dead code).

    Returns (init_positions, [(level_update_positions), ...]) with one
    entry per level; total AND gates ~ 2(w-1) instead of w(1+2*log2 w).
    """
    L = n_levels(w)
    needed = {w - 2}
    level_sets = []
    for lvl in reversed(range(L)):
        d = 1 << lvl
        level_sets.append(sorted(i for i in needed if i - d >= 0))
        needed = needed | {i - d for i in needed if i - d >= 0}
    level_sets.reverse()
    return sorted(needed), level_sets


# ---------------------------------------------------------------------------
# Per-stream round timelines
# ---------------------------------------------------------------------------

def stream_timeline(n_elements: int, width: int,
                    cone: bool = False) -> Tuple[Tuple[str, int], ...]:
    """One ReLU stream's rounds, in order: ``((phase, bytes), ...)``.

    ``bytes`` is the per-party one-direction payload of that round,
    exactly what ``comm.payload_bytes`` reports for the wire arrays
    ``core.gmw`` yields.  Width-0 (culled identity) and zero-element
    (empty batch) streams run no rounds at all — ``relu_many`` drops them
    before the lockstep loop.
    """
    w = width
    if w == 0 or n_elements == 0:
        return ()
    W = packed_words(n_elements)
    rounds: List[Tuple[str, int]] = [("others", w * W * WORD_BYTES)]
    if w > 1:
        if cone:
            init_pos, level_sets = cone_sets(w)
            rounds.append(("circuit", 2 * len(init_pos) * W * WORD_BYTES))
            # levels whose cone slice is empty are skipped by the protocol:
            # no bytes AND no round
            rounds.extend(("circuit", 2 * (2 * len(pos)) * W * WORD_BYTES)
                          for pos in level_sets if pos)
        else:
            rounds.append(("circuit", 2 * w * W * WORD_BYTES))
            rounds.extend([("circuit", 2 * (2 * w) * W * WORD_BYTES)]
                          * n_levels(w))
    rounds.append(("b2a", 2 * n_elements * RING_BYTES))
    rounds.append(("mult", 2 * n_elements * RING_BYTES))
    return tuple(rounds)


def stream_rounds(width: int, cone: bool = False) -> int:
    """Round count of one live stream (element-count independent)."""
    return len(stream_timeline(32, width, cone=cone)) if width else 0


def open_timeline(n_elements: int) -> Tuple[Tuple[str, int], ...]:
    """One Beaver-product opening's rounds: a single "open" exchange of
    ``n_elements`` ring elements (per party, one direction).

    This is the secret-by-secret product round of the transformer path
    (``gmw.products_many``): an elementwise mul of n values opens 2n
    elements, a matmul of X [.., M, K] @ Y [.., K, N] opens
    ``size(X) + size(Y)`` — the caller passes the total.  Zero-element
    opens run no round at all.
    """
    if n_elements == 0:
        return ()
    return (("open", n_elements * RING_BYTES),)


def simulate_open(n_list: Sequence[int]) -> "Schedule":
    """Fused schedule of one coalesced opening across sibling streams:
    every stream's single "open" payload rides ONE exchange (1 round,
    summed bytes); streams opening nothing contribute nothing."""
    live = [int(n) for n in n_list if n]
    if not live:
        return Schedule.empty()
    total = sum(live) * RING_BYTES
    slot = RoundSlot(bytes_tx=total, parts=len(live),
                     phase_bytes=(("open", total),))
    return Schedule((slot,), ())


# ---------------------------------------------------------------------------
# The fused schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RoundSlot:
    """One coalesced exchange of the fused timeline."""

    bytes_tx: int                              # per party, one direction
    parts: int                                 # payloads merged in this round
    phase_bytes: Tuple[Tuple[str, int], ...]   # per-phase contributions

    @property
    def phases(self) -> Tuple[str, ...]:
        """Which protocol phases share this exchange (cross-phase overlap
        shows up here: e.g. ("circuit", "b2a") when a shallow group's B2A
        rides a deep group's adder level)."""
        return tuple(p for p, _ in self.phase_bytes)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Deterministic fused-round timeline of one ``run_streams`` call (or,
    via ``+``, of sequential calls — e.g. a full Plan replay)."""

    slots: Tuple[RoundSlot, ...]
    groups: Tuple[Tuple[int, int], ...]    # post-batching (n_elements, width)

    # -- counters (the CoalescingComm-validated pair) -------------------------
    @property
    def n_rounds(self) -> int:
        return len(self.slots)

    @property
    def round_bytes(self) -> Tuple[int, ...]:
        return tuple(s.bytes_tx for s in self.slots)

    @property
    def round_parts(self) -> Tuple[int, ...]:
        return tuple(s.parts for s in self.slots)

    @property
    def bytes_tx(self) -> int:
        return sum(s.bytes_tx for s in self.slots)

    def phase_bytes(self) -> Dict[str, int]:
        """Total bytes per protocol phase (the paper's Figure 3 categories;
        always carries all four keys, plus "frame" on framed schedules)."""
        out = {p: 0 for p in PHASES}
        for slot in self.slots:
            for phase, b in slot.phase_bytes:
                out[phase] = out.get(phase, 0) + b
        return out

    # -- latency ---------------------------------------------------------------
    def latency(self, bandwidth_bps: float, rtt_s: float,
                compute_s: float = 0.0) -> float:
        """Schedule-predicted end-to-end latency (seconds): every fused
        round pays one RTT, serialization shares the link both directions.

        Summing per-round ``rtt + wire`` equals ``n_rounds * rtt +
        total_wire``; the aggregate form is used so the result is
        bit-identical to ``costmodel.latency_model`` over this schedule's
        (bytes, rounds) pair.
        """
        wire = 2 * self.bytes_tx * 8 / bandwidth_bps
        return wire + self.n_rounds * rtt_s + compute_s

    def wall_band(self, bandwidth_bps: float, rtt_s: float,
                  host_s_per_round: float = 1.0,
                  startup_s: float = 45.0) -> Tuple[float, float]:
        """Acceptance band ``(lo, hi)`` for a *measured* end-to-end wall
        over this timeline on a real transport.

        ``lo`` is the schedule-predicted latency — physics; nothing real
        can beat it.  ``hi`` adds a per-round host budget (Python
        callback, serialization, socket syscalls — ``host_s_per_round``
        covers the loopback-measured per-round overhead, ~0.2 s/round on
        an unloaded box, with slack for a contended CI runner) and a
        one-off ``startup_s`` (process spawn, jax import, connect/accept
        handshake, jit warm-up of both parties).  The band therefore
        *tightens as the schedule shrinks*: a 21-round timeline gets a
        ~21x smaller host allowance than a 210-round one, so a
        regression that doubles per-round host work fails ``--check``
        instead of hiding under a flat multiplier (the old gate's
        ``20x pred + 120`` ceiling was ~6x the measured wall and caught
        nothing).
        """
        lo = self.latency(bandwidth_bps, rtt_s)
        hi = lo + self.n_rounds * host_s_per_round + startup_s
        return (lo, hi)

    # -- resilient-transport framing -------------------------------------------
    def framed(self, frame_bytes: int = FRAME_BYTES) -> "Schedule":
        """The same timeline as seen on a resilient transport: every fused
        round's exchange carries ``frame_bytes`` of framing (round sequence
        + checksum words, ``comm.ResilientComm``) on top of its payload.

        Round count, ordering and phase structure are untouched — framing
        is pure per-round overhead, priced as its own "frame" phase so
        ``phase_bytes()``/``gantt()`` show exactly what resilience costs.
        This is what ``benchmarks/run.py --chaos`` compares the measured
        ``ResilientComm.round_bytes`` against (re-sends excluded: they are
        recovery overhead, accounted separately).
        """
        slots = tuple(
            RoundSlot(bytes_tx=s.bytes_tx + frame_bytes, parts=s.parts,
                      phase_bytes=s.phase_bytes + (("frame", frame_bytes),))
            for s in self.slots)
        return Schedule(slots, self.groups)

    # -- rendering -------------------------------------------------------------
    def gantt(self, col: int = 6) -> str:
        """ASCII/markdown Gantt of the fused-round timeline.

        One row per protocol phase, one column per coalesced exchange;
        a ``█``-bar marks every phase contributing bytes to that round, so
        cross-phase overlap (a shallow group's B2A riding a deep group's
        adder levels) is visible as two bars in one column.  Footer rows
        carry the coalesced payload count and per-party one-direction
        bytes of each round — the exact ``CoalescingComm`` counters (and,
        on the mesh backend, the per-collective-permute payloads of the
        compiled HLO).  Drop the output in a fenced code block for
        markdown.
        """
        if not self.slots:
            return "(empty schedule: 0 rounds, 0 bytes)"

        def cell(s: str) -> str:
            return s.rjust(col)

        def fmt_bytes(b: int) -> str:
            if b < 1024:
                return str(b)
            if b < 10 * 1024:
                return f"{b / 1024:.1f}k"
            if b < 1024 * 1024:
                return f"{b // 1024}k"
            return f"{b / (1024 * 1024):.1f}M"

        extra = tuple(p for s in self.slots for p, _ in s.phase_bytes
                      if p not in PHASES)
        phases = PHASES + tuple(dict.fromkeys(extra))   # e.g. framed: "frame"
        label = max(len(p) for p in phases + ("bytes/pty", "round"))
        lines = ["round".ljust(label) + " |"
                 + "".join(cell(str(r + 1)) for r in range(self.n_rounds))]
        for phase in phases:
            contrib = [dict(s.phase_bytes).get(phase, 0) for s in self.slots]
            if not any(contrib):
                continue
            bar = "█" * (col - 2)
            lines.append(phase.ljust(label) + " |" + "".join(
                cell(bar if b else "·") for b in contrib))
        lines.append("payloads".ljust(label) + " |"
                     + "".join(cell(str(s.parts)) for s in self.slots))
        lines.append("bytes/pty".ljust(label) + " |"
                     + "".join(cell(fmt_bytes(s.bytes_tx)) for s in self.slots))
        lines.append(f"total: {self.n_rounds} fused rounds, "
                     f"{self.bytes_tx} B/party one-direction")
        return "\n".join(lines)

    # -- composition -----------------------------------------------------------
    def __add__(self, other: "Schedule") -> "Schedule":
        """Sequential composition: ``other`` starts after ``self`` ends
        (separate ``relu_many`` calls never share rounds)."""
        return Schedule(self.slots + other.slots, self.groups + other.groups)

    @staticmethod
    def empty() -> "Schedule":
        return Schedule((), ())


def batch_specs(specs: Iterable) -> List[Tuple[int, int]]:
    """Merge streams with an identical batch key into one (n, w) group.

    Each spec is ``(n_elements, width)`` or ``(n_elements, width,
    batch_key)``; the default key is ``(n_elements, width)``.  The engine
    batches by ``(n_elements, k, m)`` — callers that distinguish (k, m)
    pairs of equal width pass that as the explicit key.  Groups keep
    first-appearance order, matching ``gmw.relu_many``.
    """
    order: List = []
    merged: Dict = {}
    for spec in specs:
        n, w = int(spec[0]), int(spec[1])
        key = spec[2] if len(spec) > 2 else (n, w)
        if key not in merged:
            merged[key] = [0, w]
            order.append(key)
        if merged[key][1] != w:
            raise ValueError(
                f"batch key {key!r} mixes widths {merged[key][1]} and {w}")
        merged[key][0] += n
    return [(merged[k][0], merged[k][1]) for k in order]


def simulate(specs: Iterable, cone: bool = False,
             auto_batch: bool = True) -> Schedule:
    """Fused round schedule of one ``relu_many``/``run_streams`` call.

    ``specs``: iterable of ``(n_elements, width)`` or ``(n_elements,
    width, batch_key)`` — one entry per concurrent protocol stream.  With
    ``auto_batch`` (the engine default) identical-key streams merge into
    one batched stream first; ragged groups stay separate and are
    per-payload coalesced.
    """
    if auto_batch:
        groups = batch_specs(specs)
    else:
        groups = [(int(s[0]), int(s[1])) for s in specs]
    timelines = [stream_timeline(n, w, cone=cone) for n, w in groups]
    slots = []
    for r in range(max((len(t) for t in timelines), default=0)):
        contrib: Dict[str, int] = {}
        parts = 0
        for t in timelines:
            if r < len(t):
                phase, b = t[r]
                contrib[phase] = contrib.get(phase, 0) + b
                parts += 1
        slots.append(RoundSlot(
            bytes_tx=sum(contrib.values()), parts=parts,
            phase_bytes=tuple((p, contrib[p]) for p in PHASES
                              if p in contrib)))
    live = tuple((n, w) for n, w in groups if n and w)
    return Schedule(tuple(slots), live)


def simulate_merged(request_calls: Sequence[Sequence], cone: bool = False,
                    auto_batch: bool = True) -> Schedule:
    """Fused timeline of a *merged micro-batch*: N concurrent request
    replays advancing call-by-call in lockstep.

    ``request_calls[r]`` is request r's replay as a sequence of per-call
    specs — ``(n_elements, width)`` or ``(n_elements, width, batch_key)``,
    i.e. ``api.Plan.call_specs()``.  Call j of the merged batch runs every
    request's j-th ReLU call in ONE ``relu_many`` lockstep (sibling
    payloads coalesced; identical batch keys merged when ``auto_batch``),
    so the batch pays max-over-requests rounds per call instead of the
    sum — this is the serving engine's execution order and the latency
    query its batching policy closes batches on.  Requests with fewer
    calls simply drop out of later call slots.
    """
    n_calls = max((len(calls) for calls in request_calls), default=0)
    total = Schedule.empty()
    for j in range(n_calls):
        specs = [calls[j] for calls in request_calls if j < len(calls)]
        total = total + simulate(specs, cone=cone, auto_batch=auto_batch)
    return total
