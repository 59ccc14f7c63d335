"""Leakage census over the port's comm seam: what actually goes on the
wire carries no unmasked share (the port's counterpart of the
reference's ``analysis/taint.py``).

The GMW round seam guarantees that every wire payload is either pure
session randomness (the A2B round's masks) or a secret blinded by a
Beaver triple or a session-derived mask (``d = x ^ a``, ``e = x - a``).
The reference proves this on its compiled artifact, walking the HLO of
``serve_step`` with per-value taint flags.  The port has no such program:
its rounds are Python generators over CUDA kernels.  So the census checks
the payloads themselves, by differential execution at the comm seam.

A ``RecordingComm`` (a ``CoalescingComm`` over ``SimComm``) hands every
round's payloads, as protocol code queued them and before they are
flattened onto the wire, to the census: exactly what a real backend would
send, one list of payloads per fused round, both parties' rows.  One call
runs three times:

- (A) as given: ``x``, the triple pool ``T`` and the key;
- (B) fresh input shares ``x'`` (a fresh sharing of a fresh plaintext,
  so a value recombined from the shares changes too), same ``T`` and key;
- (C) the same ``x``, a fresh pool ``T'`` and key ``key'``.

Each element of a round's payloads (an int32 word or an int64 ring value,
in the payload's own dtype) is

- *secret-derived* if A != B,
- *masked* if A != C,
- *unmasked* if A != B and A == C: it moved with the secret and no mask
  reached it.

A round is unmasked if any element is, masked if any element is masked
(and none unmasked), public otherwise.  The check is one-sided, as the
reference's: mask cancellation (``x ^ r ^ r``) is not tracked, so a value
that re-exposes a secret by reusing its mask still counts as masked.  A
masked int32 word equals its own value under a fresh mask with
probability 2^-32 (an int64 value 2^-64), which would flag it; so the
elements C flags are checked once more against a fourth run (D: the same
``x``, another fresh pool and key), and only those equal in all of A, C
and D count as unmasked: 2^-64 per word.  A true leak is equal in all
three.

It never passes vacuously: ``census_summary`` holds the recorded rounds
and bytes against ``plan.schedule()``, round for round, and requires
that some element moved with the input shares (a call that ignores its
input, or a run B given the same shares, tests nothing); and every run
must repeat A's round structure (payload shapes and dtypes) exactly, or
the census raises ``CensusError`` (a round structure that moves with the
input or the masks is itself a leak).

The census needs the generator loop: the captured replay
(``runtime/loop.py``) bakes its exchanges into a CUDA graph, and no
Python comm ever sees them.  The census selects it in code: its comm is a
``CoalescingComm`` subclass, which ``loop.compiled_eligible`` refuses
whatever ``HB_ROUND_LOOP`` says, and ``serve_step_census`` checks that
before it runs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core import comm as comm_lib

Payloads = List[torch.Tensor]


class CensusError(RuntimeError):
    """The census could not compare the runs: their round structure (the
    number of rounds, a payload's shape or dtype) differs."""


class RecordingComm(comm_lib.CoalescingComm):
    """``CoalescingComm`` over ``SimComm`` that hands each round's queued
    payloads to ``observe(payloads)`` before the round fires."""

    def __init__(self, observe: Callable[[Payloads], None]):
        super().__init__(comm_lib.SimComm())
        self.observe = observe

    def flush(self) -> List[torch.Tensor]:
        if self._queue:
            self.observe(list(self._queue))
        return super().flush()


def _structure(payloads: Payloads):
    return [(tuple(p.shape), p.dtype) for p in payloads]


def _element_diff(a: Payloads, b: Payloads) -> torch.Tensor:
    """Flat bool: where two rounds of one structure differ, element by
    element of each payload."""
    return torch.cat([(pa != pb).reshape(-1) for pa, pb in zip(a, b)])


@dataclasses.dataclass(frozen=True)
class RoundTaint:
    """One fused round's payload, classed element by element."""

    index: int
    bytes: int          # per party, one direction (``comm.payload_bytes``)
    elements: int       # both parties' payload elements
    secret: int         # elements that moved with the input shares (A != B)
    masked: int         # elements that moved with the masks (A != C)
    unmasked: int       # secret-derived elements no mask reached

    @property
    def kind(self) -> str:
        if self.unmasked:
            return "unmasked"
        return "masked" if self.masked else "public"


Run = Callable[[comm_lib.CoalescingComm, object, object], object]


def _pass(run: Run, x, masks, want: Optional[List[Payloads]],
          on_round: Callable[[int, Payloads], None], what: str) -> None:
    """One run of ``run(comm, x, masks)`` on a fresh ``RecordingComm``;
    ``on_round(r, payloads)`` sees every round.  Against ``want`` (run A's
    rounds) each round must repeat A's payload shapes and dtypes."""
    seen = [0]

    def observe(payloads):
        r = seen[0]
        if want is not None and (r >= len(want)
                                 or _structure(want[r]) != _structure(payloads)):
            raise CensusError(
                f"round {r}: the payloads' structure changed with {what} "
                f"({_structure(payloads)}); the census compares runs of one "
                f"round structure")
        on_round(r, payloads)
        seen[0] += 1

    run(RecordingComm(observe), x, masks)
    if want is not None and seen[0] != len(want):
        raise CensusError(f"{what}: {seen[0]} rounds against the first run's "
                          f"{len(want)}")


def leakage_census(run: Run, x, masks, x_fresh,
                   fresh_masks: Callable[[int], object]) -> List[RoundTaint]:
    """Class every round of ``run(comm, x, masks)``'s wire traffic (see the
    module docstring).  ``x_fresh``: other input shares of the same
    structure; ``fresh_masks(i)``: the i-th fresh masking material (pool
    and key), i = 1 for run C and, only when C leaves a suspect, 2 for
    the confirming run D.  A's payloads stay where they were made (on
    the card for a card run) and B, C and D are compared round by round."""
    recorded: List[Payloads] = []
    _pass(run, x, masks, None,
          lambda r, payloads: recorded.append([p.clone() for p in payloads]), "")
    if not recorded:
        return []
    moved: List[torch.Tensor] = [None] * len(recorded)

    def on_b(r, payloads):
        moved[r] = _element_diff(recorded[r], payloads)

    _pass(run, x_fresh, masks, recorded, on_b, "the input shares")
    counts: List[torch.Tensor] = []

    def on_c(r, payloads):
        masked = _element_diff(recorded[r], payloads)
        counts.append(torch.stack([moved[r].sum(), masked.sum()]))
        moved[r] = moved[r] & ~masked          # now: the suspects

    _pass(run, x, fresh_masks(1), recorded, on_c, "the masks")
    if bool(torch.stack([s.any() for s in moved]).any()):
        def on_d(r, payloads):
            moved[r] &= ~_element_diff(recorded[r], payloads)

        _pass(run, x, fresh_masks(2), recorded, on_d, "the masks")
    unmasked = torch.stack([s.sum() for s in moved]).tolist()
    secret_masked = torch.stack(counts).tolist()
    return [RoundTaint(index=r, bytes=sum(comm_lib.payload_bytes(p) for p in payloads),
                       elements=moved[r].numel(), secret=int(sm[0]),
                       masked=int(sm[1]), unmasked=int(u))
            for r, (payloads, sm, u) in enumerate(zip(recorded, secret_masked,
                                                      unmasked))]


def census_summary(rounds: Sequence[RoundTaint], schedule) -> Dict:
    """The reference's summary keys over the classed rounds, and the
    cross-check against ``schedule`` (a ``core.schedule.Schedule``): the
    recorded rounds and bytes must equal its, round for round, and some
    element must have moved with the input shares."""
    kinds = [r.kind for r in rounds]
    round_bytes = tuple(r.bytes for r in rounds)
    secret = sum(r.secret for r in rounds)
    return {
        "collectives": len(rounds),
        "unmasked_collectives": kinds.count("unmasked"),
        "masked_collectives": kinds.count("masked"),
        "public_collectives": kinds.count("public"),
        "secret_elements": secret,
        "first_secret_round": next((r.index for r in rounds if r.secret), None),
        "unmasked_elements": sum(r.unmasked for r in rounds),
        "bytes": sum(round_bytes),
        "sched_rounds": schedule.n_rounds,
        "sched_bytes": schedule.bytes_tx,
        "cross_check_ok": (len(rounds) == schedule.n_rounds > 0
                           and round_bytes == tuple(schedule.round_bytes)
                           and secret > 0),
    }


def serve_step_census(model, x: torch.Tensor, triples, key: torch.Tensor,
                      x_fresh: torch.Tensor,
                      fresh_masks: Callable[[int], Tuple[object, torch.Tensor]]
                      ) -> Dict:
    """The census of one ``model.serve_step()(model.params, x, triples, key)`` call
    (``x``: the int64 (2, B, ...) input shares; ``triples``: the plan's
    pool; ``fresh_masks(i)``: a fresh ``(triples, key)`` pair), each run on
    a copy of ``model`` whose session holds the recording comm, on the
    generator loop.  Returns ``census_summary`` against
    ``model.schedule()`` plus ``rounds``, the classed rounds."""
    from ..api import Session, compile as compile_model
    from ..runtime import loop as loop_lib

    def run(comm, x_, masks):
        if loop_lib.compiled_eligible(comm):
            raise CensusError("the census comm would take the captured replay, "
                              "whose exchanges no Python comm sees")
        triples_, key_ = masks
        session = Session(key=key_, comm=comm, device=x_.device)
        copy = compile_model(model.apply_fn, model.params, model.cfg, model.plan,
                             session, mpc_forward=model.mpc_forward,
                             auto_batch=model.auto_batch)
        return copy.serve_step()(model.params, x_, triples_, key_)

    rounds = leakage_census(run, x, (triples, key), x_fresh, fresh_masks)
    summary = census_summary(rounds, model.schedule())
    summary["rounds"] = rounds
    return summary


def _resnet_plans(cfg, params, batch: int, hw: int, names: Sequence[str]):
    from ..core.hummingbird import HBConfig, HBLayer
    from ..models import resnet

    exact = resnet.trace(params, cfg, batch=batch, hw=hw)
    reduced = exact.with_hb(HBConfig(
        tuple([HBLayer(k=21, m=13)] * (exact.n_groups - 1) + [HBLayer(k=13, m=13)]),
        exact.group_elements))
    plans = {"exact": exact, "reduced": reduced}
    return {name: plans[name] for name in names}


def resnet_census(cfg, batch: int, hw: int, device, names: Sequence[str],
                  seed: int = 0) -> Dict[str, Dict]:
    """The census of one ``serve_step`` of a ResNet under the named plans
    (``exact``; ``reduced``: (21, 13) on every ReLU group but the last,
    which is culled at (13, 13)), with weights, input, pools and keys all
    derived from ``seed``."""
    from .. import api
    from ..core import beaver, prng
    from ..core.mpc_tensor import MPCTensor
    from ..models import resnet

    params = resnet.init(cfg, seed=seed, device=device)
    gen = torch.Generator().manual_seed(seed + 1)

    def shares(i):
        x = torch.rand((batch, 3, hw, hw), generator=gen) * 2 - 1
        return MPCTensor.from_plain(prng.PRNGKey(seed + i, device),
                                    x.to(device)).data

    x, x_fresh = shares(2), shares(3)
    out = {}
    for name, plan in _resnet_plans(cfg, params, batch, hw, names).items():
        def masks(i, plan=plan):
            return (beaver.gen_plan_triples(prng.PRNGKey(seed + 10 * i + 4, device),
                                            plan.triple_specs()),
                    prng.PRNGKey(seed + 10 * i + 5, device))

        model = api.compile(
            lambda p, v, relu_fn=None: resnet.apply(p, v, cfg, relu_fn=relu_fn),
            params, cfg, plan, api.Session(key=seed, device=device))
        triples, key = masks(0)
        out[name] = serve_step_census(model, x, triples, key, x_fresh, masks)
    return out


def combine(summaries: Dict[str, Dict]) -> Dict:
    """One summary over several plans' censuses: counts summed,
    ``cross_check_ok`` only if every plan's holds; ``plans`` keeps each."""
    keys = ("collectives", "unmasked_collectives", "masked_collectives",
            "public_collectives", "secret_elements", "unmasked_elements", "bytes", "sched_rounds",
            "sched_bytes")
    out = {k: sum(s[k] for s in summaries.values()) for k in keys}
    out["cross_check_ok"] = all(s["cross_check_ok"] for s in summaries.values())
    out["plans"] = {name: {k: v for k, v in s.items() if k != "rounds"}
                    for name, s in summaries.items()}
    return out


def canonical_resnet_census(device=None) -> Dict:
    """The acceptance census, on the card unless ``device`` says otherwise
    (``device.resolve``).  On the CPU the reference's fixture:
    ``RESNET_SMOKE`` at input (2, 3, 8, 8) under ``HBLayer(21, 13)`` on every
    group but the last, which gets ``HBLayer(13, 13)``.  On the card
    full-width ResNet-18 at batch 4 under the exact and reduced plans.
    Returns ``combine`` of the plans' summaries."""
    from ..configs import RESNET18, RESNET_SMOKE
    from ..device import resolve

    device = resolve(device)
    if device.type == "cuda":
        return combine(resnet_census(RESNET18, 4, RESNET18.in_hw, device,
                                     ("exact", "reduced")))
    return combine(resnet_census(RESNET_SMOKE, 2, 8, device, ("reduced",)))
