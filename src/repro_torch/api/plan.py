"""Plan: the offline artifact of HummingBird private inference (twin of the
reference's ``api/plan.py``).

A Plan records what the online phase replays: the model's ReLU call sites
in call order (element count, group, shape), its secret-by-secret product
sites (``opens``: one Beaver open round each, at its place among the ReLU
calls), the per-group HummingBird (k, m) assignment, and whether the
cone-pruned adder is used.  Its JSON and ``digest()`` are byte-identical
to the reference's for the same model, so the two packages agree on which
network they run.  ``trace_plan`` runs the plaintext torch forward on the
``meta`` device (the reference uses ``jax.eval_shape``): shapes only, no
data, no compute.  ``gantt`` and ``estimate`` read the copied
``core/schedule.py``, so they give the reference's text and floats.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import pathlib
from typing import Dict, List, Optional, Tuple, Union

import torch

from .. import errors
from ..core import schedule as schedule_lib
from ..core.costmodel import CommCost
from ..core.hummingbird import HBConfig


# ---------------------------------------------------------------------------
# Network presets (the paper's §5.2 evaluation setup)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NetworkPreset:
    name: str
    bandwidth_bps: float          # one-direction link bandwidth, bits/s
    rtt_s: float


HIGHBW = NetworkPreset("highbw", 16e12 / 8, 10e-6)  # NVLink-class
LAN = NetworkPreset("lan", 10e9 / 8, 50e-6)         # 10 Gbps, 50 us
WAN = NetworkPreset("wan", 352e6 / 8, 20e-3)        # 352 Mbps, 20 ms (paper)
NETWORKS = {p.name: p for p in (HIGHBW, LAN, WAN)}


@dataclasses.dataclass(frozen=True)
class ReluCall:
    """One ReLU call site: element count, (k, m) group, shape (no party dim)."""

    n_elements: int
    group: int
    shape: Tuple[int, ...]

    def to_json(self) -> Dict:
        return {"n_elements": self.n_elements, "group": self.group,
                "shape": list(self.shape)}

    @staticmethod
    def from_json(d: Dict) -> "ReluCall":
        return ReluCall(int(d["n_elements"]), int(d["group"]),
                        tuple(int(s) for s in d["shape"]))


@dataclasses.dataclass(frozen=True)
class OpenCall:
    """One Beaver-product open site (a secret-by-secret mul or matmul): the
    ring elements its single exchange carries a party, one direction (2n
    for an elementwise mul of n, size(X) + size(Y) for a matmul), and its
    place in program order (``at_call``: the ReLU calls before it)."""

    n_elements: int
    at_call: int
    label: str = ""

    def to_json(self) -> Dict:
        return {"n_elements": self.n_elements, "at_call": self.at_call,
                "label": self.label}

    @staticmethod
    def from_json(d: Dict) -> "OpenCall":
        return OpenCall(int(d["n_elements"]), int(d["at_call"]),
                        str(d.get("label", "")))


@dataclasses.dataclass(frozen=True)
class Plan:
    """Network plan: ReLU call trace, Beaver open sites, and the per-group
    HummingBird assignment."""

    calls: Tuple[ReluCall, ...]
    hb: HBConfig
    input_shape: Tuple[int, ...] = ()
    cone: bool = False
    name: str = ""
    opens: Tuple[OpenCall, ...] = ()

    # -- derived views --------------------------------------------------------
    @property
    def n_groups(self) -> int:
        return self.hb.n_groups

    @property
    def group_elements(self) -> Tuple[int, ...]:
        return self.hb.group_elements

    def with_hb(self, hb: HBConfig) -> "Plan":
        """Same trace, new (k, m) assignment."""
        assert hb.n_groups == self.hb.n_groups, (hb.n_groups, self.hb.n_groups)
        return dataclasses.replace(self, hb=hb)

    def triple_specs(self) -> Tuple[Tuple[int, int], ...]:
        """(n_elements, width) per ReLU call."""
        return tuple((c.n_elements, self.hb.layers[c.group].width)
                     for c in self.calls)

    def call_specs(self) -> Tuple[Tuple[int, int, Tuple[int, int, int]], ...]:
        """``(n_elements, width, (n_elements, k, m))`` per ReLU call: one
        ``core.schedule.simulate`` spec with its auto-batch key."""
        specs = []
        for c in self.calls:
            layer = self.hb.layers[c.group]
            specs.append((c.n_elements, layer.width,
                          (c.n_elements, layer.k, layer.m)))
        return tuple(specs)

    def open_specs(self) -> Tuple[int, ...]:
        """Ring elements opened per Beaver-product site, in program order
        (one ``core.schedule.simulate_open`` spec each)."""
        return tuple(o.n_elements for o in self.opens)

    # -- analytics ------------------------------------------------------------
    def schedule(self, streams: int = 1,
                 auto_batch: bool = True) -> schedule_lib.Schedule:
        """Fused-round timeline of one replay over ``streams`` sibling
        streams: one ``relu_many`` lockstep per call, and each open site's
        one coalesced round before the call it precedes; sequential calls
        and opens never share rounds, so their schedules compose with
        ``+``."""
        if not self.calls and self.n_groups:
            raise ValueError("cost/schedule need a traced plan (trace_plan)")
        opens_at: Dict[int, List[OpenCall]] = {}
        for o in self.opens:
            opens_at.setdefault(o.at_call, []).append(o)
        total = schedule_lib.Schedule.empty()
        for j, spec in enumerate(self.call_specs()):
            for o in opens_at.get(j, ()):
                total = total + schedule_lib.simulate_open([o.n_elements] * streams)
            total = total + schedule_lib.simulate(
                [spec] * streams, cone=self.cone, auto_batch=auto_batch)
        for o in opens_at.get(len(self.calls), ()):
            total = total + schedule_lib.simulate_open([o.n_elements] * streams)
        return total

    def gantt(self, streams: int = 1, auto_batch: bool = True) -> str:
        """Per-call ASCII Gantt of one replay (``Schedule.gantt`` for each
        ReLU call, phases as rows and fused rounds as columns), then the
        replay's total; the reference's text, character for character."""
        if not self.calls and self.n_groups:
            raise ValueError(
                "gantt needs a traced plan: this plan was built without a "
                "call list (Plan.from_hb) — use trace_plan / model-specific "
                "trace() to get one")
        blocks: List[str] = []
        total = schedule_lib.Schedule.empty()
        for idx, (c, spec) in enumerate(zip(self.calls, self.call_specs())):
            layer = self.hb.layers[c.group]
            sched = schedule_lib.simulate([spec] * streams, cone=self.cone,
                                          auto_batch=auto_batch)
            total = total + sched
            head = (f"call {idx}: group {c.group}  k={layer.k} m={layer.m} "
                    f"width={layer.width}  {c.n_elements} el"
                    + (f" x {streams} streams" if streams > 1 else ""))
            if not sched.slots:
                blocks.append(f"{head}  — culled (0 rounds, 0 bytes)")
                continue
            blocks.append(head + "\n" + sched.gantt())
        blocks.append(f"replay total: {total.n_rounds} fused rounds, "
                      f"{total.bytes_tx} B/party one-direction")
        return "\n\n".join(blocks)

    def cost(self, streams: int = 1, auto_batch: bool = True) -> CommCost:
        """Closed-form ReLU communication of one replay (schedule totals)."""
        sched = self.schedule(streams=streams, auto_batch=auto_batch)
        return CommCost(sched.bytes_tx, sched.n_rounds, sched.phase_bytes())

    def estimate(self, bandwidth_bps: Optional[float] = None,
                 rtt_s: Optional[float] = None, *,
                 network: Union[NetworkPreset, str, None] = None,
                 streams: int = 1, compute_s: float = 0.0,
                 auto_batch: bool = True) -> float:
        """ReLU latency estimate (seconds) of one replay: the schedule's
        fused rounds priced one RTT each, serialization sharing the link,
        under explicit (bandwidth_bps, rtt_s) or a ``NETWORKS`` preset."""
        if network is not None:
            preset = NETWORKS[network] if isinstance(network, str) else network
            bandwidth_bps, rtt_s = preset.bandwidth_bps, preset.rtt_s
        if bandwidth_bps is None or rtt_s is None:
            raise ValueError("estimate needs (bandwidth_bps, rtt_s) or network=")
        return self.schedule(streams=streams, auto_batch=auto_batch).latency(
            bandwidth_bps, rtt_s, compute_s)

    # -- (de)serialization ----------------------------------------------------
    def to_json(self) -> Dict:
        d = {"name": self.name, "input_shape": list(self.input_shape),
             "cone": self.cone, "hb": self.hb.to_json(),
             "calls": [c.to_json() for c in self.calls]}
        if self.opens:
            # only plans with secret-by-secret products carry the key, as in
            # the reference, so plans without keep their digests
            d["opens"] = [o.to_json() for o in self.opens]
        return d

    @staticmethod
    def from_json(d: Dict) -> "Plan":
        return Plan(calls=tuple(ReluCall.from_json(c) for c in d["calls"]),
                    hb=HBConfig.from_json(d["hb"]),
                    input_shape=tuple(int(s) for s in d["input_shape"]),
                    cone=bool(d["cone"]), name=str(d.get("name", "")),
                    opens=tuple(OpenCall.from_json(o) for o in d.get("opens", [])))

    def validate(self) -> "Plan":
        """Static pre-flight of a loaded plan; raises ``errors.PlanInvalid``
        on (k, m) outside 0 <= m <= k <= 64, a call naming a missing group
        or disagreeing with its shape, group element drift, triple-spec
        drift, an open with negative elements or outside the call order, or
        a composed schedule that differs from the per-call and per-open
        sum."""
        hb = self.hb
        if len(hb.layers) != len(hb.group_elements):
            raise errors.PlanInvalid(
                f"plan {self.name!r}: {len(hb.layers)} HB layers vs "
                f"{len(hb.group_elements)} group element counts")
        for g, layer in enumerate(hb.layers):
            if not 0 <= layer.m <= layer.k <= 64:
                raise errors.PlanInvalid(
                    f"plan {self.name!r}: group {g} has (k={layer.k}, "
                    f"m={layer.m}) outside 0 <= m <= k <= 64")
        per_group = [0] * self.n_groups
        for i, c in enumerate(self.calls):
            if not 0 <= c.group < self.n_groups:
                raise errors.PlanInvalid(
                    f"plan {self.name!r}: call {i} references group "
                    f"{c.group} but the HB config has {self.n_groups}")
            if c.n_elements < 0 or c.n_elements != math.prod(c.shape):
                raise errors.PlanInvalid(
                    f"plan {self.name!r}: call {i} claims {c.n_elements} "
                    f"elements but shape {c.shape} has {math.prod(c.shape)}")
            per_group[c.group] += c.n_elements
        if self.calls and tuple(per_group) != tuple(self.group_elements):
            raise errors.PlanInvalid(
                f"plan {self.name!r}: per-call element sums {per_group} "
                f"!= hb.group_elements {list(self.group_elements)}")
        for i, ((n, w), c) in enumerate(zip(self.triple_specs(), self.calls)):
            if n != c.n_elements or w != hb.layers[c.group].width \
                    or not 0 <= w <= 64:
                raise errors.PlanInvalid(
                    f"plan {self.name!r}: triple spec {i} is ({n}, {w})")
        for i, o in enumerate(self.opens):
            if o.n_elements < 0:
                raise errors.PlanInvalid(
                    f"plan {self.name!r}: open {i} claims {o.n_elements} elements")
            if not 0 <= o.at_call <= len(self.calls):
                raise errors.PlanInvalid(
                    f"plan {self.name!r}: open {i} sits at call position "
                    f"{o.at_call} but the plan has {len(self.calls)} ReLU calls")
        if self.calls:
            total = self.schedule()
            rounds = bytes_tx = 0
            for spec in self.call_specs():
                per_call = schedule_lib.simulate([spec], cone=self.cone)
                rounds += per_call.n_rounds
                bytes_tx += per_call.bytes_tx
            for n in self.open_specs():
                per_open = schedule_lib.simulate_open([n])
                rounds += per_open.n_rounds
                bytes_tx += per_open.bytes_tx
            if (total.n_rounds, total.bytes_tx) != (rounds, bytes_tx):
                raise errors.PlanInvalid(
                    f"plan {self.name!r}: composed schedule "
                    f"({total.n_rounds} rounds, {total.bytes_tx} B) != "
                    f"per-call sum ({rounds} rounds, {bytes_tx} B)")
        return self

    def digest(self) -> str:
        """Short stable content hash of the plan (canonical JSON)."""
        blob = json.dumps(self.to_json(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def save(self, path) -> None:
        pathlib.Path(path).write_text(json.dumps(self.to_json(), indent=1))

    @staticmethod
    def load(path) -> "Plan":
        """Load + statically validate a saved plan."""
        try:
            plan = Plan.from_json(json.loads(pathlib.Path(path).read_text()))
        except (KeyError, ValueError, TypeError, AssertionError) as e:
            raise errors.PlanInvalid(f"malformed plan file {path}: {e}") from e
        return plan.validate()

    @staticmethod
    def from_hb(hb: HBConfig, cone: bool = False, name: str = "") -> "Plan":
        """Trace-free plan (execution only; no cost or triple accounting)."""
        return Plan(calls=(), hb=hb, cone=cone, name=name)


def _to_meta(tree):
    if isinstance(tree, torch.Tensor):
        return tree.to("meta")
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_meta(v) for v in tree)
    return tree


def trace_plan(apply_fn, params, x, *, hb: Optional[HBConfig] = None,
               n_groups: Optional[int] = None, cone: bool = False,
               name: str = "") -> Plan:
    """Shape-trace ``apply_fn(params, x, relu_fn=...)`` into a Plan.

    ``x`` is an example input tensor or a plain shape tuple (float32).  The
    forward runs on the ``meta`` device, so nothing is computed;
    ``relu_fn(v, g)`` call sites are recorded in call order, and so are
    the secret-product sites a model reaches through ``relu_fn.matmul`` /
    ``relu_fn.mul`` (one Beaver open each); ``hb`` defaults to the exact
    64-bit assignment.
    """
    shape = tuple(int(s) for s in (x if isinstance(x, (tuple, list)) else x.shape))
    calls: List[ReluCall] = []
    opens: List[OpenCall] = []

    def tracing_relu(v, g):
        calls.append(ReluCall(int(v.numel()), int(g), tuple(int(s) for s in v.shape)))
        return v

    def tracing_matmul(a, b):
        opens.append(OpenCall(int(a.numel() + b.numel()), at_call=len(calls),
                              label="matmul"))
        return torch.matmul(a, b)

    def tracing_mul(a, b):
        opens.append(OpenCall(int(2 * a.numel()), at_call=len(calls), label="mul"))
        return a * b

    tracing_relu.matmul = tracing_matmul
    tracing_relu.mul = tracing_mul

    apply_fn(_to_meta(params), torch.empty(shape, device="meta"),
             relu_fn=tracing_relu)
    n = n_groups if n_groups is not None else (
        hb.n_groups if hb is not None
        else (max(c.group for c in calls) + 1 if calls else 0))
    elements = [0] * n
    for c in calls:
        elements[c.group] += c.n_elements
    if hb is None:
        hb = HBConfig.exact(elements)
    else:
        # keep the caller's (k, m) layers, always carry the traced counts
        assert hb.n_groups == n, (hb.n_groups, n)
        hb = HBConfig(hb.layers, tuple(elements))
    return Plan(calls=tuple(calls), hb=hb, input_shape=shape, cone=cone,
                name=name, opens=tuple(opens))
