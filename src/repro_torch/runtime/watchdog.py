"""Shared straggler detection: per-observation wall-clock EWMA (a copy of
the reference's ``runtime/watchdog.py``, which is stdlib only).

The serving engine (``serve/engine.py``) observes each executed batch's
wall time per fused round; the reference's training loop uses the same
detector per step.  An observation slower than ``factor`` x the EWMA is
flagged; the first observation seeds the EWMA and the first ``warmup``
observations are never flagged (compilation and cache warmup land there).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional


class StragglerWatchdog:
    """EWMA-based slow-observation detector.

    ``observe(tag, dt)`` absorbs one timed unit of work (a fused round, a
    training step) and returns whether it was a straggler; flagged tags
    accumulate in ``stragglers``.  Observation 1 seeds the EWMA (never
    flagged), observations up to ``warmup`` update but never flag, and
    from there a ``dt > factor * ewma`` flags BEFORE the EWMA absorbs it
    (so one slow outlier cannot hide itself).
    """

    def __init__(self, factor: float = 3.0, alpha: float = 0.1,
                 warmup: int = 2):
        self.factor = factor
        self.alpha = alpha
        self.warmup = warmup
        self.ewma: Optional[float] = None
        self.stragglers: List[Any] = []
        self._n = 0

    def observe(self, tag: Any, dt: float,
                on_straggler: Optional[Callable] = None) -> bool:
        self._n += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = self._n > self.warmup and dt > self.factor * self.ewma
        if slow:
            self.stragglers.append(tag)
            if on_straggler is not None:
                on_straggler(tag, dt, self.ewma)
        self.ewma = (1.0 - self.alpha) * self.ewma + self.alpha * dt
        return slow
