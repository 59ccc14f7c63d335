"""party_host: run ONE party of the 2PC protocol as its own OS process
(twin of the reference's ``launch/party_host.py``, same arguments, exit
codes and output files, plus ``--device``).

The deployment entry point::

    # terminal 1: party 0 hosts the link
    python -m repro_torch.launch.party_host --party 0 --job jobdir \
        --listen 127.0.0.1:9000

    # terminal 2: party 1 dials in
    python -m repro_torch.launch.party_host --party 1 --job jobdir \
        --peer 127.0.0.1:9000

Both processes load their own view of the job directory (their input share
rows + their slice of the offline triple pool, see ``transport.job``),
handshake (session seed, plan digest, party complement), and replay the
SAME plan with ``Session.connect``'s resilience stack underneath: socket
timeouts heal by idempotent re-send, and with ``--journal DIR`` every
verified fused round is journaled and snapshotted every
``--snapshot-every`` rounds, so a killed process restarts, renegotiates
the common journal prefix with its peer, replays it without touching the
wire, and finishes bit-identically.

Modes:

- one-shot (default): run the job's private inference once, write
  ``out{party}.npz`` (this party's output share rows, ``lo``/``hi`` uint32
  limbs) and ``stats{party}.json`` (measured rounds/bytes/wall) into the
  job directory, exit 0.
- ``--follow``: serve engine batches (the follower side of
  ``transport.engine_link``; the leader is a ``serve.frontend`` process).

Exit codes: 0 done, 2 bad arguments, 3 handshake failed, 17 = peer
crashed mid-run (restartable: relaunch both parties with the same
arguments), 42 = the ``--die-after-round`` test hook.

``--device`` picks where shares, triples and kernels live (default
``cuda``; it raises without a card, pass ``--device cpu`` there).  Link
shaping (``--rtt-ms`` / ``--mbps``) injects a link profile so measured
wall-clock can be checked against ``core.schedule`` latency predictions.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

import numpy as np

from .. import api, errors, transport
from ..core import beaver, comm as comm_lib, faults as faults_lib, prng, ring
from ..checkpoint import store
from ..device import resolve as resolve_device
from ..models import resnet
from ..transport.socket import parse_address

EXIT_RESTART = 17


class _DieAfterRounds:
    """Test hook: hard-kill this process after N completed rounds (above
    the journal, so the journal holds exactly N rounds when we die:
    deterministic crash injection for the resume tests)."""

    def __init__(self, base, n_rounds: int):
        self.base = base
        self.n_parties = base.n_parties
        self.left = int(n_rounds)

    def swap(self, x):
        out = self.base.swap(x)
        self.left -= 1
        if self.left <= 0:
            os._exit(42)                   # simulated kill -9, no cleanup
        return out

    def party_is(self, p, template):
        return self.base.party_is(p, template)

    def party_slice(self, full):
        return self.base.party_slice(full)


def _model_afn(cfg):
    def afn(p, v, relu_fn=None):
        return resnet.apply(p, v, cfg, relu_fn=relu_fn)
    return afn


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="party_host", description=__doc__.split("\n")[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--party", type=int, required=True, choices=(0, 1))
    ap.add_argument("--job", required=True, help="job directory "
                    "(see repro_torch.transport.job.write_job)")
    ap.add_argument("--listen", default=None,
                    help="host:port to bind + accept the peer on")
    ap.add_argument("--peer", default=None,
                    help="host:port of the hosting peer to dial")
    ap.add_argument("--rtt-ms", type=float, default=0.0,
                    help="injected round-trip time (link shaping)")
    ap.add_argument("--mbps", type=float, default=0.0,
                    help="injected bandwidth cap in Mbit/s (0 = unshaped)")
    ap.add_argument("--timeout-s", type=float, default=30.0)
    ap.add_argument("--max-retries", type=int, default=3)
    ap.add_argument("--handshake-timeout-s", type=float, default=120.0)
    ap.add_argument("--journal", default=None,
                    help="directory for round-journal snapshots; an "
                    "existing committed snapshot is resumed from")
    ap.add_argument("--snapshot-every", type=int, default=1)
    ap.add_argument("--die-after-round", type=int, default=0,
                    help="test hook: os._exit after N live rounds")
    ap.add_argument("--follow", action="store_true",
                    help="serve engine batches (follower mode) instead "
                    "of the one-shot job inference")
    ap.add_argument("--device", default="cuda",
                    help="torch device for shares, triples and kernels")
    return ap


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if (args.listen is None) == (args.peer is None):
        print("pass exactly one of --listen / --peer", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    job = (transport.load_party(args.job, args.party, device) if not args.follow
           else transport.load_job(args.job))
    cfg, plan = job["cfg"], job["plan"]
    params = resnet.init(cfg, seed=job["params_seed"], device=device)
    shaper = None
    if args.rtt_ms > 0 or args.mbps > 0:
        shaper = transport.LinkShaper(
            rtt_s=args.rtt_ms / 1e3,
            bandwidth_bps=(args.mbps * 1e6 if args.mbps > 0
                           else float("inf")))

    journal = None
    if args.journal is not None:
        if store.latest_step(args.journal) is not None:
            journal = faults_lib.RoundJournal.load(args.journal)
            print(f"party {args.party}: resuming from journal with "
                  f"{len(journal)} rounds", flush=True)
        else:
            journal = faults_lib.RoundJournal()

    provider = (beaver.TriplePool(job["pool"]) if "pool" in job else None)
    try:
        session = api.Session.connect(
            args.party,
            listen=(parse_address(args.listen) if args.listen else None),
            peer=(parse_address(args.peer) if args.peer else None),
            key=job["session_seed"], provider=provider,
            session_id=str(job["session_seed"]), plan_digest=plan.digest(),
            journal=journal, snapshot_dir=args.journal,
            snapshot_every=args.snapshot_every, shaper=shaper,
            timeout_s=args.timeout_s, max_retries=args.max_retries,
            handshake_timeout_s=args.handshake_timeout_s, device=device)
    except errors.HandshakeFailed as e:
        print(f"party {args.party}: handshake failed: {e}", file=sys.stderr)
        return 3
    sock = session.transport
    if args.die_after_round > 0:
        session.comm = _DieAfterRounds(session.comm, args.die_after_round)

    model = api.compile(_model_afn(cfg), params, cfg, plan, session)
    try:
        if args.follow:
            served = transport.serve_follower(
                sock, model,
                provider_factory=transport.tenant_provider_factory(
                    job["ttp_seed"], party=args.party, device=device),
                max_retries=args.max_retries)
            print(f"party {args.party}: served {served} batches",
                  flush=True)
            return 0
        return _one_shot(args, job, model, session, sock)
    except errors.PartyCrashed as e:
        # snapshot whatever completed so the relaunch resumes, not restarts
        if args.journal is not None:
            journaled = comm_lib.find_comm(session.comm,
                                           faults_lib.JournaledComm)
            if journaled is not None and len(journaled.journal):
                journaled.snapshot(args.journal)
        print(f"party {args.party}: peer crashed ({e}); exit "
              f"{EXIT_RESTART} for restart + journal resume",
              file=sys.stderr)
        return EXIT_RESTART
    finally:
        sock.close()


def _one_shot(args, job, model, session, sock) -> int:
    journaled = comm_lib.find_comm(session.comm, faults_lib.JournaledComm)
    resilient = comm_lib.find_resilient(session.comm)
    t0 = time.monotonic()
    out = model(job["X"], key=prng.PRNGKey(job["infer_key"], session.device))
    lo, hi = ring.to_limbs(out.data)        # waits for the device
    wall = time.monotonic() - t0
    out_dir = pathlib.Path(args.job)
    np.savez(out_dir / f"out{args.party}.npz", lo=lo, hi=hi)
    stats = {
        "party": args.party,
        "rounds": sock.n_swaps,
        "payload_bytes": sock.bytes_tx,
        "header_bytes": sock.header_bytes,
        "dup_dropped": sock.dup_dropped,
        "retries": resilient.retries if resilient else 0,
        "recovered": resilient.recovered if resilient else 0,
        "replayed": journaled.replayed if journaled else 0,
        "resume_round": sock.negotiated.get("resume_round", 0),
        "wall_s": wall,
        "shaped": sock.shaper is not None,
    }
    (out_dir / f"stats{args.party}.json").write_text(
        json.dumps(stats, indent=1))
    print(f"party {args.party}: {stats['rounds']} rounds, "
          f"{stats['payload_bytes']} payload bytes, "
          f"{wall:.3f}s wall ({stats['replayed']} replayed from journal)",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
