"""The least bytes of the GMW adders a call runs (frozen).

Each ReLU of width w = k - m > 1 over E elements runs a Kogge-Stone
adder on W = ceil(E / 32) packed words per bit plane and party.  Only
the backward cone of the carry into the sign bit is needed, so the count
is the cone form's: per round, the rows of W words per party it must
read or write once (the AND gates' sent and received (d, e) and triple
(a, b, c), 7 rows a gate; the prefix rows it updates; the next round's
payload rows).  The count depends only on w and E: the dense form of the
adder (every prefix position) moves more bytes than this for the same
work, so its share of this yardstick is lower.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Tuple

from . import peaks

#: the program's adder kernels (dense and cone forms), by symbol
KERNEL_PATTERN = (r"(?<![A-Za-z_])(beaver_and|ks_mask|ks_step|ks_combine|"
                  r"ks_level|cone_step)_kernel")


def n_levels(w: int) -> int:
    return max(0, math.ceil(math.log2(w))) if w > 1 else 0


def cone_levels(w: int) -> List[Tuple[int, int, int, int]]:
    """Per non-empty Kogge-Stone level of the sign bit's cone: (level,
    first, step, count) of the prefix positions it updates."""
    needed = {w - 2}
    level_sets = []
    for lvl in reversed(range(n_levels(w))):
        d = 1 << lvl
        level_sets.append(sorted(i for i in needed if i - d >= 0))
        needed |= {i - d for i in needed if i - d >= 0}
    level_sets.reverse()
    out = []
    for lvl, pos in enumerate(level_sets):
        if pos:
            out.append((lvl, pos[0], 2 << lvl, len(pos)))
    return out


def round_rows(w: int, r: int) -> int:
    """Rows of W words per party that round r touches once (r = 0: after
    the initial AND's exchange; r = i: after cone level i's)."""
    levels = cone_levels(w)
    if r == 0:
        and_rows, g_read, upd, p_written = w - 1, set(), set(range(w - 1)), set()
    else:
        _, first, step, n = levels[r - 1]
        and_rows, upd = 2 * n, set(range(first, first + step * n, step))
        g_read, p_written = upd, upd
    moved = 7 * and_rows + len(g_read) + len(upd) + len(p_written)
    if r < len(levels):
        lvl, first, step, n = levels[r]
        nxt = set(range(first, first + step * n, step))
        src = {i - (1 << lvl) for i in nxt}
        return moved + len((nxt | src) - p_written) + len(src - upd) + 8 * n
    return moved + (w - 1 not in p_written) + (w - 2 not in upd) + 1


def adder_bytes(w: int, n_elements: int, parties: int = 2) -> int:
    """Least bytes of one adder of width w over ``n_elements``."""
    if w < 2 or n_elements == 0:
        return 0
    n_words = (n_elements + 31) // 32
    return sum(4 * parties * (n_words * round_rows(w, r) + 1)
               for r in range(1 + len(cone_levels(w))))


def call_bytes(relu_calls: Iterable[Tuple[int, int]]) -> int:
    """Least adder bytes of a call: ``relu_calls`` holds (width, elements
    of every stream together) per ReLU call."""
    return sum(adder_bytes(w, e) for w, e in relu_calls)


def least_s(relu_calls) -> float:
    return call_bytes(relu_calls) / peaks.HBM_BYTES_PER_S
