"""Typed error hierarchy for the whole stack.

Callers — above all the serving engine's batch-retry loop and any future
real transport — need to distinguish *retryable* failures (a transient
network fault that an idempotent re-send or a batch re-execution can
absorb) from *fatal* ones (a quota breach, a shape the model cannot
serve).  Every raise site in ``core.comm``/``core.faults``/
``core.beaver``/``api``/``serve`` goes through this module instead of
ad-hoc ``RuntimeError``/``ValueError``s.

Design rules:

- ``RetryableError`` marks transience; ``is_retryable(exc)`` is the one
  question the engine asks before re-running a batch.
- Errors that replaced a historical builtin raise also subclass that
  builtin (``ShapeMismatch`` is a ``ValueError``, ``UnregisteredModel`` a
  ``KeyError``, ``TripleBudgetExceeded`` a ``RuntimeError``), so existing
  ``except``/``pytest.raises`` call sites keep working.
- Request-scoped errors carry ``request_id``/``tenant`` attributes
  (``attach_request`` fills them in) so a failed future's exception
  identifies its origin without string parsing.

This module is import-light on purpose (stdlib only): ``core.comm`` and
``core.faults`` sit below every protocol module and import it.
"""
from __future__ import annotations

from typing import Optional


class ReproError(Exception):
    """Base of every typed error raised by this package.

    ``request_id``/``tenant`` are filled in by the serving engine when the
    error fails a request future (``attach_request``); None elsewhere.
    """

    request_id: Optional[int] = None
    tenant: Optional[str] = None


class RetryableError(ReproError):
    """Transient: an idempotent retry (re-send, batch re-execution) may
    succeed.  The engine's batch-retry loop keys off this marker."""


class FatalError(ReproError):
    """Deterministic: retrying the same operation will fail the same way."""


# ---------------------------------------------------------------------------
# Communication faults (core.comm.ResilientComm / core.faults)
# ---------------------------------------------------------------------------

class CommError(ReproError):
    """Base of every party-communication failure."""


class CommTimeout(CommError, RetryableError):
    """An exchange was dropped or stalled past the timeout.  Raised by
    ``ResilientComm`` only after its per-round retry budget is exhausted
    (and by ``FaultInjectingComm`` to *inject* the underlying fault)."""


class PayloadCorrupted(CommError, RetryableError):
    """A received frame failed checksum or round-sequence verification.
    Retryable: the re-send is idempotent, so a transient bit flip heals."""


class PartyCrashed(CommError):
    """The peer party is gone (crash at round r).  NOT retryable by a
    plain re-send — recovery is restart + round-level resume (see
    ``core.faults.RoundJournal``); the engine retries a crashed batch only
    when an ``on_party_crash`` hook revived the transport."""


class HandshakeFailed(CommError, ConnectionError):
    """The two party processes disagree on identity at connect time —
    party index collision, session-seed or plan-digest mismatch, protocol
    version skew, or no peer within the accept/connect budget.  Fatal by
    design: running the protocol across mismatched sessions would produce
    garbage shares, so ``repro.transport`` refuses to start."""


# ---------------------------------------------------------------------------
# Serving-engine request failures (repro.serve)
# ---------------------------------------------------------------------------

class DeadlineExceeded(FatalError):
    """The request provably cannot meet its deadline: shed before any
    protocol round burns triples (schedule-predicted, not measured)."""


class ResultTimeout(ReproError, TimeoutError):
    """``RequestFuture.result(timeout_s=...)`` expired before the engine
    resolved the request."""


class DuplicateRequest(FatalError, ValueError):
    """A request id was submitted twice to one engine."""


class ShapeMismatch(FatalError, ValueError):
    """An input shape the compiled model/plan cannot serve."""


class PlanInvalid(FatalError, ValueError):
    """A loaded/JSON Plan violates its schedule invariants (out-of-range
    (k, m), element/group accounting drift, round-conservation mismatch)
    — replaying it would desynchronize the parties or the triple budget,
    so ``Plan.validate()`` refuses it before any protocol round runs."""


class UnregisteredModel(FatalError, KeyError):
    """No MPC forward is registered for the model-config type."""

    def __str__(self) -> str:        # KeyError quotes its arg; keep prose
        return Exception.__str__(self)


# ---------------------------------------------------------------------------
# Triple-supply failures (core.beaver)
# ---------------------------------------------------------------------------

class TripleBudgetExceeded(FatalError, RuntimeError):
    """A metered tenant asked for more triple material than its budget."""


class TriplePoolExhausted(FatalError, RuntimeError):
    """A precomputed triple pool ran out of bundles mid-replay."""


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def is_retryable(exc: BaseException) -> bool:
    """Should an idempotent retry be attempted for this failure?"""
    return isinstance(exc, RetryableError)


def attach_request(exc: BaseException, request_id: int,
                   tenant: str) -> BaseException:
    """Stamp a failing request's identity onto its exception (best-effort:
    foreign exception types without writable attrs are left unchanged)."""
    try:
        exc.request_id = request_id
        exc.tenant = tenant
    except (AttributeError, TypeError):      # pragma: no cover - exotic exc
        pass
    return exc
