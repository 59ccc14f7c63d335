"""§4.1.2 search engine: HummingBird-eco and HummingBird-b (twin of the
reference's ``search/engine.py``).

HummingBird-eco: m = 0, and per ReLU group the smallest k whose
validation logits equal the exact model's bit for bit (Theorem 1 starts
the walk down at ``safe_k``).

HummingBird-b: DFS over per-group bit widths with locally-optimal (k, m)
(earlier groups fixed, later ones exact), and three early stops: the
optimistic accuracy below the absolute threshold (1), not above the best
complete config (2; for the latency objective only strictly below, so
accuracy ties stay open for the tie-break), the bits budget exceeded (3).
The visit order, the counters and the tie-breaks are the reference's, so
the same model and validation set give the same config.

``objective="latency"`` scores configs by the schedule-predicted
fused-round latency of the plan's replay under a LAN/WAN/HIGHBW preset
(``simulator.config_objective``); ``"bytes"`` by its total wire bytes.

Both searches run under ``simulator.deterministic()``: eco compares
logits bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..api.plan import LAN, NETWORKS, NetworkPreset, Plan
from ..core.hummingbird import HBConfig, HBLayer, RING_BITS, safe_k
from . import simulator


@dataclasses.dataclass
class SearchResult:
    config: HBConfig
    accuracy: float
    baseline_accuracy: float
    budget_fraction: float
    search_time_s: float
    nodes_visited: int
    nodes_pruned: int
    plan: Optional[Plan] = None   # set when the search was given a Plan
    objective: str = "bytes"      # what the search scored configs by
    objective_value: Optional[float] = None   # the returned config's score:
    # total wire bytes, or fused-round latency (s) under the network preset

    def to_json(self) -> Dict:
        return {"config": self.config.to_json(),
                "accuracy": self.accuracy,
                "baseline_accuracy": self.baseline_accuracy,
                "budget_fraction": self.budget_fraction,
                "search_time_s": self.search_time_s,
                "nodes_visited": self.nodes_visited,
                "nodes_pruned": self.nodes_pruned,
                "objective": self.objective,
                "objective_value": self.objective_value,
                "plan": self.plan.to_json() if self.plan is not None else None}

    @staticmethod
    def from_json(d: Dict) -> "SearchResult":
        return SearchResult(
            config=HBConfig.from_json(d["config"]),
            accuracy=float(d["accuracy"]),
            baseline_accuracy=float(d["baseline_accuracy"]),
            budget_fraction=float(d["budget_fraction"]),
            search_time_s=float(d["search_time_s"]),
            nodes_visited=int(d["nodes_visited"]),
            nodes_pruned=int(d["nodes_pruned"]),
            objective=str(d.get("objective", "bytes")),
            objective_value=(float(d["objective_value"])
                             if d.get("objective_value") is not None else None),
            plan=(Plan.from_json(d["plan"])
                  if d.get("plan") is not None else None))


def _eval(apply_fn, params, xs, ys, cfg, key):
    return simulator.evaluate_accuracy(apply_fn, params, xs, ys, cfg, key)


def _groups_and_plan(group_elements: Union[Plan, Sequence[int]]):
    """Per-group element counts, and the Plan when one was given."""
    if isinstance(group_elements, Plan):
        return list(group_elements.group_elements), group_elements
    return list(group_elements), None


def _result(cfg: HBConfig, plan: Optional[Plan], **kw) -> SearchResult:
    return SearchResult(config=cfg, budget_fraction=cfg.budget_fraction(),
                        plan=plan.with_hb(cfg) if plan is not None else None,
                        **kw)


#: RTT at which serving latency is round-dominated (the paper's WAN preset
#: is 20 ms; LAN is 50 us).
ROUNDS_DOMINATED_RTT_S = 1e-3


def _resolve_preset(network: Union[NetworkPreset, str, None]) -> NetworkPreset:
    if network is None:
        network = LAN
    return NETWORKS[network] if isinstance(network, str) else network


def _ordered_bit_choices(bit_choices: Sequence[int], objective: str,
                         preset: NetworkPreset) -> List[int]:
    """Exploration order of the per-group widths: widest first, except for
    the latency objective on a rounds-dominated (WAN-class) network, where
    width 0 (culling the group's rounds) comes first, ascending."""
    chosen = sorted({int(w) for w in bit_choices})
    if objective == "latency" and preset.rtt_s >= ROUNDS_DOMINATED_RTT_S:
        return chosen
    return list(reversed(chosen))


def _objective_scorer(objective: str,
                      network: Union[NetworkPreset, str, None],
                      plan: Optional[Plan], group_elements: Sequence[int],
                      streams: int, cone: Optional[bool]):
    """Config -> schedule-predicted score: the plan's own ReLU calls (and
    adder mode, unless ``cone`` overrides it) when a traced Plan was given,
    else one pseudo-call per group."""
    if objective not in ("bytes", "latency"):
        raise ValueError(f"unknown objective {objective!r} "
                         "(expected 'bytes' or 'latency')")
    if cone is None:
        cone = plan.cone if plan is not None else False
    if plan is not None and plan.calls:
        calls: List[Tuple[int, int]] = [(c.n_elements, c.group)
                                        for c in plan.calls]
    else:
        calls = [(n, g) for g, n in enumerate(group_elements)]
    preset = _resolve_preset(network)

    def score(cfg: HBConfig) -> float:
        return simulator.config_objective(
            cfg, calls, objective=objective,
            bandwidth_bps=preset.bandwidth_bps, rtt_s=preset.rtt_s,
            streams=streams, cone=cone)

    return score


@simulator.deterministic()
def search_eco(apply_fn, params, xs, ys,
               group_elements: Union[Plan, Sequence[int]],
               key, margin_bits: int = 1, *, objective: str = "bytes",
               network: Union[NetworkPreset, str, None] = None,
               streams: int = 1, cone: Optional[bool] = None) -> SearchResult:
    """Zero-error config: per group the smallest k (m = 0) whose validation
    logits equal the exact model's bit for bit.  ``objective`` / ``network``
    / ``streams`` choose which schedule-predicted metric
    ``objective_value`` reports; with a Plan the result carries
    ``plan.with_hb(config)``."""
    t0 = time.time()
    group_elements, plan = _groups_and_plan(group_elements)
    score = _objective_scorer(objective, network, plan, group_elements,
                              streams, cone)
    n_groups = len(group_elements)
    base_cfg = HBConfig.exact(group_elements)
    base_acc = _eval(apply_fn, params, xs, ys, base_cfg, key)
    with torch.no_grad():
        ref_logits = apply_fn(params, xs, relu_fn=None)
    max_ints = simulator.max_activation_ints(apply_fn, params, xs, n_groups)

    def outputs_intact(cfg: HBConfig) -> bool:
        relu_fn = simulator.make_group_relu(cfg, key)
        with torch.no_grad():
            logits = apply_fn(params, xs, relu_fn=relu_fn)
        return bool(torch.equal(logits, ref_logits))

    layers = []
    nodes = 0
    for g in range(n_groups):
        k = safe_k(max_ints[g], m=0, margin_bits=margin_bits)
        # validate downward: shrink while the validation outputs are intact
        while k > 2:
            cand = list(layers) + [HBLayer(k=k - 1, m=0)] + \
                [HBLayer() for _ in range(n_groups - g - 1)]
            cfg = HBConfig(tuple(cand), tuple(group_elements))
            nodes += 1
            if not outputs_intact(cfg):
                break
            k -= 1
        layers.append(HBLayer(k=k, m=0))
    cfg = HBConfig(tuple(layers), tuple(group_elements))
    acc = _eval(apply_fn, params, xs, ys, cfg, key)
    return _result(cfg, plan, accuracy=acc, baseline_accuracy=base_acc,
                   search_time_s=time.time() - t0, nodes_visited=nodes,
                   nodes_pruned=0, objective=objective,
                   objective_value=score(cfg))


@simulator.deterministic()
def search_budget(apply_fn, params, xs, ys,
                  group_elements: Union[Plan, Sequence[int]],
                  key, budget: float, *, acc_threshold_drop: float = 0.10,
                  bit_choices: Optional[Sequence[int]] = None,
                  max_k: int = 28, objective: str = "bytes",
                  network: Union[NetworkPreset, str, None] = None,
                  streams: int = 1, cone: Optional[bool] = None,
                  on_visit=None) -> SearchResult:
    """HummingBird-b: budgeted DFS with locally-optimal (k, m).

    ``bit_choices`` may include 0 (the group's ReLU culled: zero rounds and
    bytes).  The bits budget (Early stop 3) is the paper's offline
    constraint; ``objective`` picks among equally accurate configs within
    it, and ``objective_value`` reports the returned config's score (equal
    to ``result.plan.estimate(network=...)`` for the latency objective on a
    traced plan).  ``on_visit(cfg)`` sees every evaluated candidate, and
    every complete config, in visit order."""
    t0 = time.time()
    group_elements, plan = _groups_and_plan(group_elements)
    score = _objective_scorer(objective, network, plan, group_elements,
                              streams, cone)
    latency_ties = objective == "latency"
    n_groups = len(group_elements)
    elements = np.asarray(group_elements, np.float64)
    total_bits = RING_BITS * elements.sum()
    base_cfg = HBConfig.exact(group_elements)
    base_acc = _eval(apply_fn, params, xs, ys, base_cfg, key)
    threshold = base_acc - acc_threshold_drop
    bit_choices = _ordered_bit_choices(bit_choices or (0, 4, 5, 6, 8, 10),
                                       objective, _resolve_preset(network))

    best: dict = {"acc": -1.0, "metric": float("inf"), "layers": None}
    stats = {"visited": 0, "pruned": 0}

    def _visit(cfg: HBConfig) -> None:
        stats["visited"] += 1
        if on_visit is not None:
            on_visit(cfg)

    def local_best(prefix: List[HBLayer], g: int, width: int):
        """Locally-optimal (k, m) with k - m = width for group g."""
        if width == 0:
            # culling: every k = m is the same identity layer
            cand = prefix + [HBLayer(k=0, m=0)] + \
                [HBLayer() for _ in range(n_groups - g - 1)]
            cfg = HBConfig(tuple(cand), tuple(group_elements))
            _visit(cfg)
            return HBLayer(k=0, m=0), _eval(apply_fn, params, xs, ys, cfg,
                                            key)
        best_local = (None, -1.0)
        for k in range(width, max_k + 1):
            m = k - width
            cand = prefix + [HBLayer(k=k, m=m)] + \
                [HBLayer() for _ in range(n_groups - g - 1)]
            cfg = HBConfig(tuple(cand), tuple(group_elements))
            _visit(cfg)
            acc = _eval(apply_fn, params, xs, ys, cfg, key)
            if acc > best_local[1]:
                best_local = (HBLayer(k=k, m=m), acc)
        return best_local

    def dfs(prefix: List[HBLayer], g: int, bits_used: float):
        if g == n_groups:
            cfg = HBConfig(tuple(prefix), tuple(group_elements))
            # complete configs stay out of nodes_visited (it counts
            # local_best candidates) but the hook sees them
            if on_visit is not None:
                on_visit(cfg)
            acc = _eval(apply_fn, params, xs, ys, cfg, key)
            if acc > best["acc"]:
                best["acc"] = acc
                best["metric"] = score(cfg) if latency_ties else None
                best["layers"] = tuple(prefix)
            elif latency_ties and acc == best["acc"]:
                metric = score(cfg)    # lazily: ties only, never for bytes
                if metric < best["metric"]:
                    best["metric"] = metric
                    best["layers"] = tuple(prefix)
            return
        for width in bit_choices:
            new_bits = bits_used + width * elements[g]
            # Early stop 3: even zero bits for the rest exceeds the budget
            if new_bits > budget * total_bits:
                stats["pruned"] += 1
                continue
            layer, opt_acc = local_best(prefix, g, width)
            if opt_acc < threshold:            # Early stop 1
                stats["pruned"] += 1
                continue
            # Early stop 2 (strict for the latency objective's tie-break)
            if (opt_acc < best["acc"] if latency_ties
                    else opt_acc <= best["acc"]):
                stats["pruned"] += 1
                continue
            dfs(prefix + [layer], g + 1, new_bits)

    dfs([], 0, 0.0)
    if best["layers"] is None:
        # Nothing met the budget and the threshold: the uniform smallest
        # non-zero width, each group's window at the largest zero-error k
        # (Theorem 1 via safe_k) clamped to max_k; all culled when only
        # width 0 is on offer.
        width = min(min((w for w in bit_choices if w > 0), default=0),
                    max_k)
        if width == 0:
            best["layers"] = tuple(HBLayer(k=0, m=0)
                                   for _ in range(n_groups))
        else:
            max_ints = simulator.max_activation_ints(apply_fn, params, xs,
                                                     n_groups)
            layers = []
            for g in range(n_groups):
                k = width
                for _ in range(4):   # safe_k's headroom term depends on m
                    k_next = max(width, min(max_k,
                                            safe_k(max_ints[g],
                                                   m=k - width)))
                    if k_next == k:
                        break
                    k = k_next
                layers.append(HBLayer(k=k, m=k - width))
            best["layers"] = tuple(layers)
        best["acc"] = _eval(apply_fn, params, xs, ys,
                            HBConfig(best["layers"], tuple(group_elements)),
                            key)
    cfg = HBConfig(best["layers"], tuple(group_elements))
    return _result(cfg, plan, accuracy=best["acc"], baseline_accuracy=base_acc,
                   search_time_s=time.time() - t0,
                   nodes_visited=stats["visited"],
                   nodes_pruned=stats["pruned"], objective=objective,
                   objective_value=score(cfg))
