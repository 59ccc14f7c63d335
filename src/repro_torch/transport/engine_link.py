"""Two-process serving: the engine leader / party follower link (twin of
the reference's ``transport/engine_link.py``, same CTRL messages).

The serving engine (``serve``) stays single-brained: ONE process, the
*leader*, owns the admission queue, batching policy, deadline shedding and
tenant metering, and also plays the client gateway (it secret-shares
plaintext inputs, so it briefly holds both share rows, as any client
does).  The *follower* is a bare party host: it receives each micro-batch's
descriptor over the socket's CTRL channel, replays the same plan on its
own share rows with ``PrivateModel._run_streams``, and returns its output
rows.

Per executed batch attempt (the engine's ``on_batch_attempt`` /
``on_batch_outputs`` hooks):

    leader --CTRL--> follower   batch descriptor: request ids, tenants,
                                bucketed shapes, per-request protocol
                                keys (common knowledge), frac bits,
                                auto_batch flag + the follower's input
                                share rows as one binary blob (per
                                request its lo limbs, then its hi limbs)
    both                        run_streams lockstep: every fused round
                                is one framed DATA exchange
    leader <--CTRL-- follower   the follower's output share rows

Determinism contract: both sides derive per-request key iterators from
the SAME protocol keys and draw triples from the SAME per-tenant TTP
stream (``tenant_provider_factory`` seeded identically, each side keeping
its own party slice), so the combined output shares are bit-identical to
a single-process ``SimComm`` run of the same requests.

A retried batch re-sends its descriptor (the hook runs per attempt); the
follower rolls its providers back on any comm fault and waits for the
next descriptor, so both sides re-execute from the same triple stream
positions.
"""
from __future__ import annotations

import math
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import errors
from ..core import beaver, comm as comm_lib, prng, ring
from ..core.mpc_tensor import MPCTensor
from ..device import Device, resolve as resolve_device
from .socket import SocketComm


def tenant_provider_factory(ttp_seed: int, party: Optional[int] = None,
                            device: Device = None):
    """The canonical per-tenant triple source for socket deployments.

    Every tenant gets its own ``StreamingTTP`` stream on ``device``
    (default the GPU), forked from ``ttp_seed`` by a stable hash of the
    tenant name.  Both parties construct the factory with the SAME seed;
    each passes its own ``party`` index to keep only its slice of every
    generated bundle (``beaver.PartySlicedTTP``), so the two processes'
    triples are consistent by construction.  ``party=None`` yields the
    full 2-party stream: the single-process reference.
    """
    device = resolve_device(device)

    def factory(tenant: str):
        key = prng.fold_in(prng.PRNGKey(ttp_seed, device),
                           zlib.crc32(tenant.encode()) & 0x7FFFFFFF)
        base = beaver.StreamingTTP(key)
        return base if party is None else beaver.PartySlicedTTP(base, party)

    return factory


def _limb_bytes(data: torch.Tensor) -> bytes:
    """A ring tensor's rows as the reference sends them: lo limbs, then hi."""
    lo, hi = ring.to_limbs(data)
    return lo.tobytes() + hi.tobytes()


def _limb_rows(blob: bytes, off: int, shape, device):
    """(ring tensor (1, *shape), next offset) from lo then hi limbs at off."""
    n = math.prod(shape)
    lo = np.frombuffer(blob, np.uint32, count=n, offset=off)
    hi = np.frombuffer(blob, np.uint32, count=n, offset=off + 4 * n)
    return (ring.from_limbs(lo, hi, device).reshape((1,) + tuple(shape)),
            off + 8 * n)


class EngineLink:
    """Binds an ``InferenceEngine`` (whose session came from
    ``Session.connect``) to the follower party over the socket's CTRL
    channel.  Installing the link sets the engine's transport hooks;
    ``shutdown()`` releases the follower's serve loop.
    """

    def __init__(self, engine, sock: Optional[SocketComm] = None, *,
                 outputs_timeout_s: float = 600.0):
        self.engine = engine
        self.sock = sock if sock is not None else comm_lib.find_comm(
            engine.session.comm, SocketComm)
        if self.sock is None:
            raise ValueError(
                "EngineLink needs a SocketComm at the bottom of the "
                "engine session's comm stack (build it with "
                "Session.connect)")
        self.outputs_timeout_s = outputs_timeout_s
        engine.on_batch_attempt = self._on_attempt
        engine.on_batch_outputs = self._on_outputs

    def _on_attempt(self, admitted) -> List[MPCTensor]:
        party, peer = self.sock.party, 1 - self.sock.party
        desc = {"type": "batch",
                "auto_batch": bool(self.engine.policy.merge_identical),
                "requests": [
                    {"id": int(r.id), "tenant": r.tenant,
                     "shape": [int(s) for s in r.shape],
                     "frac_bits": int(r.x.frac_bits),
                     "key": [int(v) for v in r.key.tolist()]}
                    for r in admitted]}
        blob = b"".join(_limb_bytes(r.x.data[peer:peer + 1]) for r in admitted)
        self.sock.send_ctrl(desc, blob)
        return [MPCTensor(r.x.data[party:party + 1], r.x.frac_bits)
                for r in admitted]

    def _on_outputs(self, admitted, outs) -> List[MPCTensor]:
        hdr, blob = self.sock.recv_ctrl(timeout_s=self.outputs_timeout_s)
        if hdr.get("type") != "outputs":
            raise errors.PayloadCorrupted(
                f"expected an outputs ctrl message, got {hdr.get('type')!r}")
        ids = [int(r.id) for r in admitted]
        if hdr.get("ids") != ids:
            raise errors.PayloadCorrupted(
                f"follower answered requests {hdr.get('ids')}, leader "
                f"executed {ids}")
        party = self.sock.party
        combined, off = [], 0
        for out, shape in zip(outs, hdr["shapes"]):
            peer_rows, off = _limb_rows(blob, off, shape, out.data.device)
            rows = [out.data, peer_rows] if party == 0 else [peer_rows, out.data]
            combined.append(MPCTensor(torch.cat(rows, dim=0), out.frac_bits))
        return combined

    def shutdown(self) -> None:
        """Release the follower's serve loop (best-effort)."""
        try:
            self.sock.send_ctrl({"type": "shutdown"})
        except errors.CommError:
            pass


def serve_follower(sock: SocketComm, model, *, provider_factory,
                   max_retries: int = 3, backoff_s: float = 0.01) -> int:
    """The follower party's serve loop: replay every batch descriptor the
    leader ships until a shutdown message (or the leader's death).

    ``model`` is the follower's compiled ``PrivateModel`` (same plan, same
    public params); ``provider_factory(tenant)`` must mirror the leader's
    triple streams party-sliced to THIS side: use
    ``tenant_provider_factory(ttp_seed, party=sock.party)`` with the job's
    shared seed.  Tensors go to the model session's device.  Returns the
    number of batches served.
    """
    device = model.session.device
    comm = comm_lib.CoalescingComm(
        comm_lib.ResilientComm(sock, max_retries=max_retries,
                               backoff_s=backoff_s))
    providers: Dict[str, object] = {}
    served = 0
    while True:
        try:
            hdr, blob = sock.recv_ctrl(timeout_s=None)
        except errors.PartyCrashed:
            return served                  # leader went away: we are done
        if hdr.get("type") == "shutdown":
            return served
        if hdr.get("type") != "batch":
            raise errors.PayloadCorrupted(
                f"unexpected ctrl message {hdr.get('type')!r} in the "
                "follower serve loop")
        reqs = hdr["requests"]
        xs, off = [], 0
        for r in reqs:
            data, off = _limb_rows(blob, off, r["shape"], device)
            xs.append(MPCTensor(data, int(r["frac_bits"])))
        key_iters = [
            iter(prng.split(torch.tensor(r["key"], dtype=torch.int64,
                                         device=device), 256))
            for r in reqs]
        for r in reqs:
            if r["tenant"] not in providers:
                providers[r["tenant"]] = provider_factory(r["tenant"])
        provs = [providers[r["tenant"]] for r in reqs]
        tokens = [(p, p.checkpoint()) for p in dict.fromkeys(provs)]
        try:
            outs = model._run_streams(xs, key_iters, provs, comm,
                                      model.params,
                                      auto_batch=bool(hdr["auto_batch"]))
        except errors.CommError:
            # the leader will retry (new descriptor) or give up (next
            # message is a shutdown / the connection drops): rewind the
            # triple streams so a retry redraws identical bundles
            for p, tok in tokens:
                p.rollback(tok)
            continue
        sock.send_ctrl({"type": "outputs",
                        "ids": [int(r["id"]) for r in reqs],
                        "shapes": [[int(s) for s in o.shape] for o in outs]},
                       b"".join(_limb_bytes(o.data) for o in outs))
        served += 1
