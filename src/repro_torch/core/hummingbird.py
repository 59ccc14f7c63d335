"""HummingBird configuration: which bits each ReLU layer/group keeps.

A config assigns every ReLU group a pair (k, m): DReLU is evaluated on
<x>[k:m], a (k-m)-bit reduced ring (Eq. 3).  k = 64, m = 0 is the exact
CrypTen baseline.  Budgets are expressed as in the paper: the total number
of DReLU bits summed over all ReLU evaluations relative to 64 bits each
(e.g. budget 8/64 means the weighted mean of (k-m) must be <= 8).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

RING_BITS = 64


@dataclasses.dataclass(frozen=True)
class HBLayer:
    """Reduced-ring spec for one ReLU group."""

    k: int = RING_BITS
    m: int = 0

    def __post_init__(self):
        # k == m (width 0) is the paper's ReLU-culling mode: the layer is
        # assigned zero DReLU bits and degrades to the identity.
        assert 0 <= self.m <= self.k <= RING_BITS, (self.k, self.m)

    @property
    def width(self) -> int:
        return self.k - self.m

    @property
    def is_identity(self) -> bool:
        """Zero assigned bits degenerates ReLU to identity (ReLU culling)."""
        return self.k == self.m

    def to_json(self) -> Dict:
        return {"k": self.k, "m": self.m}

    @staticmethod
    def from_json(d: Dict) -> "HBLayer":
        return HBLayer(k=int(d["k"]), m=int(d["m"]))


@dataclasses.dataclass(frozen=True)
class HBConfig:
    """Per-group (k, m) assignments plus group sizes for budget accounting.

    ``group_elements[g]`` is the number of ReLU elements (activations) in
    group g for one inference; budgets weight each group by its element
    count, mirroring the paper's note that early CNN layers dominate.
    """

    layers: Tuple[HBLayer, ...]
    group_elements: Tuple[int, ...]

    def __post_init__(self):
        assert len(self.layers) == len(self.group_elements)

    @property
    def n_groups(self) -> int:
        return len(self.layers)

    def bits_used(self) -> int:
        return sum(l.width * e for l, e in zip(self.layers, self.group_elements))

    def bits_baseline(self) -> int:
        return RING_BITS * sum(self.group_elements)

    def budget_fraction(self) -> float:
        return self.bits_used() / max(1, self.bits_baseline())

    def meets_budget(self, budget: float) -> bool:
        return self.budget_fraction() <= budget + 1e-12

    @staticmethod
    def exact(group_elements: Sequence[int]) -> "HBConfig":
        return HBConfig(
            tuple(HBLayer() for _ in group_elements), tuple(group_elements)
        )

    def to_json(self) -> Dict:
        return {"layers": [l.to_json() for l in self.layers],
                "group_elements": list(self.group_elements)}

    @staticmethod
    def from_json(d: Dict) -> "HBConfig":
        return HBConfig(tuple(HBLayer.from_json(l) for l in d["layers"]),
                        tuple(int(e) for e in d["group_elements"]))


def safe_k(max_abs_int: float, m: int = 0, margin_bits: int = 0) -> int:
    """Smallest k with zero sign-estimation error for |x_int| <= max_abs_int.

    Theorem 1 requires -2^(k-1) <= x < 2^(k-1).  When m > 0, Theorem 2's
    floor(x/2^m) - 1 case needs one extra value of headroom at the negative
    edge (underflow case (2) of the proof): -2^(k-1) + 2^m <= x.
    """
    need = max_abs_int + (1 << m if m > 0 else 0)
    k = max(2, math.ceil(math.log2(max(need, 1))) + 1 + margin_bits)
    return min(k, RING_BITS)


def prune_threshold_float(m: int, frac_bits: int = 16) -> float:
    """Theorem 2: dropping m low bits prunes activations below 2^(m-frac)."""
    return float(2 ** (m - frac_bits))
