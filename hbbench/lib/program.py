"""The system under test, bound to one cell: the port's
``PrivateModel.__call__`` between ``PrivateModel.encrypt`` and
``MPCTensor.reveal``, on ``CoalescingComm(SimComm())`` (both parties on
one device), with one call's triple pool made by ``Session.offline`` and
rolled back to its checkpoint before every call.

This is the only harness module that imports the program.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch

from . import rng


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _span(name: str, on: bool):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


class _Clock:
    """Synchronized laps on the host clock."""

    def __init__(self, device):
        self.device = device
        _sync(device)
        self.t = time.perf_counter()

    def lap(self) -> float:
        _sync(self.device)
        t, self.t = self.t, time.perf_counter()
        return self.t - t


class Program:
    """Set up once (weights, plan, pool, compiled model); ``call(i)`` then
    serves call ``i``: ``clients`` fresh requests with seeded inputs and
    keys, as sibling streams.  With ``frac_bits`` (the control) the inputs
    are shared at that many fractional bits, which every later fixed-point
    step of the program follows."""

    def __init__(self, cell, seed: int, device, frac_bits=None):
        from repro_torch import api
        from repro_torch.core import comm as comm_lib, prng

        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.clients = int(cell.workload["clients"])
        self._prng = prng
        self.frac_bits = frac_bits
        mod = cell.model
        clock = _Clock(self.device)
        weights = mod.make_weights(cell.cfg, seed, self.device)
        self.split = {"weights_s": clock.lap()}
        params, port_cfg, plan = mod.program(cell.cfg, weights, cell.plan,
                                             self.device)
        self.split["plan_s"] = clock.lap()
        self.plan = plan
        self.schedule = plan.schedule(streams=self.clients)
        self.comm = comm_lib.CoalescingComm(comm_lib.SimComm())
        self.session = api.Session(key=rng.key(seed, "session") >> 1,
                                   comm=self.comm, device=self.device)
        self.model = api.compile(None, params, port_cfg, plan, self.session)
        clock.lap()
        self.session.offline(prng.PRNGKey(rng.key(seed, "pool") >> 1, self.device),
                             plan, requests=1, streams=self.clients)
        self.pool_build_s = self.split["pool_build_s"] = clock.lap()
        self.pool_bytes = self.session.provider.device_bytes()
        self.token = self.session.provider.checkpoint()
        self._last_enc = None
        self._host = None
        self._spare = []

    def launches(self) -> int:
        from repro_torch.kernels import ops
        return sum(ops.launch_counts().values())

    def replayed(self) -> bool:
        """Whether the last call's stream signature has a captured replay."""
        return (self._last_enc is not None
                and self.model.replay_stats(self._last_enc) is not None)

    def reserve(self, n: int, like: torch.Tensor) -> None:
        """Set aside ``n`` pinned host buffers shaped as ``like`` (set-up),
        so that a kept call's logits land in a buffer of their own at the
        cost of any other call's."""
        if self.device.type == "cuda":
            self._spare = [torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
                           for _ in range(n)]

    def _to_host(self, logits: torch.Tensor, keep: bool) -> torch.Tensor:
        """The logits on the host: with ``keep``, in a reserved buffer of
        their own (a clone where none is left); otherwise in the buffer
        every call reuses (pinned on a card)."""
        if self.device.type != "cuda":
            return logits
        if keep and self._spare:
            return self._spare.pop().copy_(logits)
        if self._host is None or self._host.shape != logits.shape:
            self._host = torch.empty(logits.shape, dtype=logits.dtype, pin_memory=True)
        self._host.copy_(logits)
        return self._host.clone() if keep else self._host

    def _encrypt(self, key, x):
        if self.frac_bits is None:
            return self.model.encrypt(key, x)
        from repro_torch.core.mpc_tensor import MPCTensor
        return MPCTensor.from_plain(key, x, frac_bits=self.frac_bits)

    def call(self, i: int, spans: bool = False, annotate: bool = False,
             keep: bool = False) -> Dict:
        """Serve call ``i``.  The latency runs from the first encrypt to the
        revealed logits on the host: with ``keep`` in a buffer the caller
        keeps, otherwise in one the next call overwrites.  With ``spans``
        the encrypt, the private call and the reveal are each ended by a
        synchronize and timed apart; with ``annotate`` each is a profiler
        range."""
        prng, mod = self._prng, self.cell.model
        self.session.provider.rollback(self.token)
        with _span("hbbench.inputs", annotate):
            xs = mod.make_inputs(self.cell.cfg, self.seed, i, self.clients,
                                 self.device)
            keys = [prng.PRNGKey(rng.key(self.seed, "enc", i, j) >> 1, self.device)
                    for j in range(self.clients)]
            call_key = prng.PRNGKey(rng.key(self.seed, "call", i) >> 1, self.device)
        r0, b0, l0 = self.comm.n_rounds, len(self.comm.round_bytes), self.launches()
        if spans:
            _sync(self.device)
        t0 = time.perf_counter()
        with _span("hbbench.encrypt", annotate):
            enc = [self._encrypt(k, x) for k, x in zip(keys, xs)]
        if spans:
            _sync(self.device)
        t1 = time.perf_counter()
        with _span("hbbench.call", annotate):
            outs = self.model(enc, key=call_key)
        if spans:
            _sync(self.device)
        t2 = time.perf_counter()
        with _span("hbbench.reveal", annotate):
            logits = self._to_host(torch.cat([o.reveal() for o in outs]), keep)
        t3 = time.perf_counter()
        self._last_enc = enc
        return {"logits": logits, "latency_s": t3 - t0, "encrypt_s": t1 - t0,
                "call_s": t2 - t1, "reveal_s": t3 - t2,
                "rounds": self.comm.n_rounds - r0,
                "bytes": sum(self.comm.round_bytes[b0:]),
                "launches": self.launches() - l0}

    def close(self) -> None:
        """Free the program's state: model, pool, captured replays."""
        import importlib
        importlib.import_module("repro_torch.api.compile")._REPLAY_CACHE.clear()
        self.session.provider = None
        self.model = self.session = self._last_enc = None
        self._host, self._spare = None, []
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
