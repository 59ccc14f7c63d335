"""Closed-form communication cost model for the GMW ReLU protocol.

Bytes and rounds are exact deterministic functions of (n_elements, ring
width); tests validate these formulas against collective-permute bytes
parsed from the compiled mesh-backend HLO, and the benchmarks use them to
reproduce the paper's Figure 3 / Figure 11 communication numbers.

All byte counts are *per party per direction* (what one party transmits);
with 2 parties, total wire traffic is 2x these numbers.

Every cost here is derived from ``core.schedule`` — the deterministic
round-timeline simulator of the fused engine — so rounds, per-round
bytes and the per-phase breakdown all come from the same source of truth
``CoalescingComm`` is validated against (``schedule`` is import-light and
sits below the protocol modules, which also removes the historical
costmodel -> gmw lazy-import cycle around ``cone_sets``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from . import schedule as schedule_lib
from .hummingbird import HBConfig, RING_BITS
from .schedule import RING_BYTES, WORD_BYTES  # noqa: F401  (re-export)


@dataclasses.dataclass(frozen=True)
class CommCost:
    bytes_tx: int                 # per party, one direction
    rounds: int
    breakdown: Dict[str, int]     # paper Figure 3 categories

    def __add__(self, other: "CommCost") -> "CommCost":
        bd = dict(self.breakdown)
        for k, v in other.breakdown.items():
            bd[k] = bd.get(k, 0) + v
        return CommCost(self.bytes_tx + other.bytes_tx,
                        self.rounds + other.rounds, bd)

    @staticmethod
    def zero() -> "CommCost":
        return CommCost(0, 0, {})


def _from_schedule(sched: schedule_lib.Schedule) -> CommCost:
    return CommCost(sched.bytes_tx, sched.n_rounds, sched.phase_bytes())


def relu_cost(n_elements: int, w: int = RING_BITS,
              cone: bool = False) -> CommCost:
    """One ReLU over n_elements with a w-bit DReLU ring (w = k - m).

    w = 0 is the culled identity layer (HBLayer.is_identity) and
    n_elements = 0 the empty-batch stream: zero bytes, zero rounds.
    cone=True prices the MSB-cone-pruned adder (same rounds except for
    skipped empty cone levels, O(w) gates instead of O(w log w) —
    EXPERIMENTS.md §Perf iteration C2).  Delegates to the round-schedule
    simulator (``core.schedule.stream_timeline``)."""
    return _from_schedule(schedule_lib.simulate([(n_elements, w)], cone=cone))


def model_relu_cost(cfg: HBConfig) -> CommCost:
    """Total ReLU communication of a model under an HBConfig."""
    total = CommCost.zero()
    for layer, n in zip(cfg.layers, cfg.group_elements):
        total = total + relu_cost(n, layer.width)
    return total


def relu_many_cost(specs, cone: bool = False,
                   auto_batch: bool = True) -> CommCost:
    """Round-fused cost of sibling ReLU groups evaluated by ``relu_many``.

    specs: iterable of (n_elements, width) — or (n_elements, width,
    batch_key) to control auto-batching exactly as the engine does (it
    merges streams of identical (n_elements, k, m) into the batch
    dimension; the default key is (n_elements, width)).  Distinct groups
    each send their own payload per round but every round is ONE coalesced
    exchange, so rounds = max over groups; auto-batched groups additionally
    repack into one payload, which can only shrink bytes.  This is the
    counter pair CoalescingComm reports and tests validate against —
    delegates to ``core.schedule.simulate``.
    """
    return _from_schedule(
        schedule_lib.simulate(specs, cone=cone, auto_batch=auto_batch))


def fused_model_relu_cost(cfg: HBConfig, streams: int,
                          cone: bool = False) -> CommCost:
    """Model-level round-fused cost: `streams` sibling inference streams
    evaluated by relu_many at every ReLU layer.  Identical sibling
    streams auto-batch, so per layer the engine runs one batched stream
    of ``streams * n`` elements; rounds are paid once per layer."""
    total = CommCost.zero()
    for layer, n in zip(cfg.layers, cfg.group_elements):
        total = total + relu_many_cost([(n, layer.width)] * streams,
                                       cone=cone)
    return total


def reduction_factors(cfg: HBConfig) -> Dict[str, float]:
    base = model_relu_cost(HBConfig.exact(cfg.group_elements))
    hb = model_relu_cost(cfg)
    return {
        "bytes_reduction": base.bytes_tx / max(1, hb.bytes_tx),
        "rounds_reduction": base.rounds / max(1, hb.rounds),
        "bits_discarded_frac": 1.0 - cfg.budget_fraction(),
    }


def latency_model(cost: CommCost, bandwidth_bps: float, rtt_s: float,
                  compute_s: float = 0.0) -> float:
    """End-to-end latency estimate: serialization + per-round RTT + compute.

    This is the projection methodology the paper uses for its WAN numbers
    (§5.2: communication measured, then scaled by assumed bandwidth).
    """
    wire = 2 * cost.bytes_tx * 8 / bandwidth_bps   # both directions share the link
    return wire + cost.rounds * rtt_s + compute_s
