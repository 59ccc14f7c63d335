"""Protocol-safety analysis for the port (``hbcheck``; twin of the
reference's ``repro.analysis``).

Three machine checks of the invariants HummingBird's security argument
rests on, over the port's own code and what it puts on the wire:

- ``analysis.lint``: AST rules R001-R006 over ``src/repro_torch``: raw
  exchanges (comm methods and ``torch.distributed`` primitives) stay
  inside the comm seam, reveals inside the approved API surface, no
  secret-dependent Python control flow (host syncs included), session-
  derived randomness only (no constant seed, no torch global-generator
  draw in protocol code), int64 ring discipline, deterministic round
  path.
- ``analysis.census``: the leakage census over the comm seam: a recording
  ``CoalescingComm`` and three runs of one ``serve_step`` (fresh input
  shares, fresh masks) class every exchanged element as masked, public or
  unmasked (zero unmasked required), with the rounds and bytes held
  against ``plan.schedule()`` and some element required to move with the
  input.
- ``analysis.locks``: lock discipline for the serving engine's
  pump-thread state, and no private reach from the frontend.

CLI gate::

    python -m repro_torch.analysis.hbcheck --check [--device cpu]

``lint``/``locks`` are stdlib-only; ``census`` imports torch and the port.
"""
from .lint import Finding, lint_paths, lint_source, load_baseline, save_baseline
from .locks import check_lock_discipline, check_private_reach

__all__ = ["Finding", "lint_paths", "lint_source", "load_baseline",
           "save_baseline", "check_lock_discipline", "check_private_reach"]
