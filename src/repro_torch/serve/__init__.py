"""repro_torch.serve: request-level serving over the fused round timeline
(twin of the reference's ``repro.serve``).

``api`` compiles one model for one caller; this package serves traffic: an
``InferenceEngine`` accepts ``submit(tenant, x)`` requests into an
admission queue, a schedule-driven ``BatchPolicy`` forms fused
micro-batches, and every batch executes its requests as sibling streams of
one plan replay, so N concurrent requests pay max-over-requests protocol
rounds instead of the sum, bit-identical to serial per-request inference.
``Frontend`` puts an HTTP server in front of an engine.
"""
from .engine import (BatchPolicy, BatchReport, InferenceEngine, Request,
                     RequestFuture)
from .frontend import Frontend

__all__ = ["InferenceEngine", "BatchPolicy", "BatchReport", "Request",
           "RequestFuture", "Frontend"]
