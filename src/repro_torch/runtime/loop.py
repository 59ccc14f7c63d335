"""Round-loop backend selection: captured replay (``scan``) vs generator
loop (``python``); twin of the reference's ``runtime/loop.py``.

The protocol primitives in ``core/gmw.py`` are round generators driven by a
Python loop: one interpreter round trip, and a few dozen kernel launches
from the host, per protocol round.  That loop is the reference backend.
The replay backend runs one ``PrivateModel`` call's whole online phase as
ONE replay of a CUDA graph, captured once per stream signature
(``api/compile.py``): the round timeline is static (``core/schedule.py``
predicts it exactly), so the forward captures straight through and every
later call refills the graph's input buffers and replays it.  The
reference's ``scan`` value selects its compiled XLA program; here it
selects the captured graph, so one setting picks the same path in both
packages.

Backend choice:

- ``HB_ROUND_LOOP=scan`` (default): captured replay wherever the comm
  backend is compatible (see ``compiled_eligible``), generator loop
  elsewhere;
- ``HB_ROUND_LOOP=python``: generator loop everywhere.

Eligibility: the replay bakes the exchange into the graph, so the comm
stack must be pure compute with no per-round Python side effects: exactly
``SimComm`` (a local flip) or ``CoalescingComm`` directly over ``SimComm``
or over a ``MeshComm`` whose party axis has size 1 (the smoke mesh: the
same local flip; its Python counters fill once, during the capture, and
are replayed onto the caller's comm by ``api/compile.py``).  A
``MeshComm`` over a party axis of size 2 exchanges through a process
group, which a CUDA graph cannot hold across gloo's host staging, so the
mesh step runs the generator loop there.  ``CountingComm`` and any
subclass must observe every round from Python, so they stay on the
generator loop.
"""
from __future__ import annotations

import os

from ..core import comm as comm_lib

_VALID = ("scan", "python")


def round_loop_mode() -> str:
    """The selected round-loop backend: ``"scan"`` (captured replay, the
    default) or ``"python"`` (generator loop).  Unknown values give the
    default, so a mistyped variable cannot take down a serving process."""
    mode = os.environ.get("HB_ROUND_LOOP", "scan")
    return mode if mode in _VALID else "scan"


def compiled_eligible(comm) -> bool:
    """True iff the whole replay may run as one captured program on this
    comm backend: exactly SimComm, or CoalescingComm directly over SimComm
    or over a MeshComm with a party axis of size 1.  Subclasses do not
    qualify: a wrapper that adds per-round Python behaviour (counters,
    framing) must see every round, which a replay never re-enters Python
    for."""
    if type(comm) is comm_lib.SimComm:
        return True
    if type(comm) is not comm_lib.CoalescingComm:
        return False
    base = comm.base
    return type(base) is comm_lib.SimComm or (
        type(base) is comm_lib.MeshComm and base.axis_size == 1)
