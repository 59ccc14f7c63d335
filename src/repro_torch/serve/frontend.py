"""Async serving frontend: HTTP in, private inference out (twin of the
``Frontend`` class of the reference's ``serve/frontend.py``).

``Frontend`` puts an asyncio HTTP server in front of an
``InferenceEngine`` and starts the engine's background pump, so a request
thread ``submit()``s and waits on its future while the pump forms and
executes fused micro-batches; ``poll``/``flush`` remain manual overrides.
HTTP parsing is hand-rolled over asyncio streams (stdlib only; one
request per connection, ``Connection: close``).

Routes (all JSON):

- ``POST /infer``  body ``{"tenant": str, "x": nested-list, optional
  "request_id", "deadline_s", "timeout_s"}`` -> ``{"id", "y", "batch":
  {rounds, requests, ...}}``.  The input is secret-shared inside
  ``submit`` (the frontend process is the client gateway) and the
  revealed output returned.
- ``GET /healthz`` liveness: queue depth, pump state, last pump error.
- ``GET /stats``   ``engine.stats()`` plus the frontend's counters and,
  when the engine session came from ``Session.connect``, the socket
  transport's wire counters (``transport``: rounds, payload/header bytes,
  dup drops, resilience retries), and this process's kernel launches
  (``launches``, the ``kernels.ops`` counters and ``pack_ring.masked``).

The output is revealed and copied to the host under the engine's
``device_lock``, so a worker thread never touches the device while the
pump captures a new stream signature's CUDA graph.

Deployment (one process per party)::

    # terminal 1: the follower party serves protocol batches
    python -m repro_torch.launch.party_host --party 1 --job jobdir \
        --listen 127.0.0.1:9000 --follow

    # terminal 2: the leader party: engine + HTTP frontend
    python -m repro_torch.serve.frontend --job jobdir \
        --peer 127.0.0.1:9000 --http 127.0.0.1:9001

    curl -s -X POST http://127.0.0.1:9001/infer \
        -d '{"tenant": "alice", "x": [[...]]}'

The leader owns the engine (admission, batching policy, shedding,
metering) and holds both share rows of each input exactly as any client
would; the follower only ever sees its own rows
(``transport.engine_link``).  Both run on ``--device`` (default ``cuda``).
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from .. import errors
from ..core import comm as comm_lib
from ..kernels import ops

_MAX_BODY = 64 << 20          # 64 MiB request cap (a batch of images is MBs)


class Frontend:
    """HTTP facade over one ``InferenceEngine`` (see module docstring).

    ``serve_background()`` runs the asyncio loop in a daemon thread and
    returns the bound (host, port); ``run_forever()`` blocks the calling
    thread.  Either way the engine pump is started so submission alone
    makes progress.

    Example::

        frontend = Frontend(engine)
        host, port = frontend.serve_background("127.0.0.1", 0)
        ...                                   # POST /infer from clients
        frontend.close()
    """

    def __init__(self, engine, *, result_timeout_s: float = 600.0):
        self.engine = engine
        self.result_timeout_s = result_timeout_s
        self.started_s = time.monotonic()
        self.requests_served = 0
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        if not engine.pump_running:
            engine.start_pump()

    # -- request handling ------------------------------------------------------
    def _infer_blocking(self, payload: Dict) -> Dict:
        """Runs on a worker thread: submit, wait on the pump, reveal."""
        if "x" not in payload:
            raise ValueError("body must carry 'x' (nested list input)")
        x = np.asarray(payload["x"], dtype=np.float32)
        fut = self.engine.submit(
            str(payload.get("tenant", "default")), x,
            request_id=payload.get("request_id"),
            deadline_s=payload.get("deadline_s"))
        t0 = time.monotonic()
        out = fut.result(timeout_s=float(payload.get(
            "timeout_s", self.result_timeout_s)))
        with self.engine.device_lock:
            y = out.reveal().cpu()
        resp = {"id": fut.request.id,
                "tenant": fut.request.tenant,
                "y": y.tolist(),
                "wall_s": time.monotonic() - t0}
        if fut.report is not None:
            resp["batch"] = {
                "n_requests": fut.report.n_requests,
                "measured_rounds": fut.report.measured_rounds,
                "predicted_rounds": fut.report.predicted_rounds,
                "measured_bytes": fut.report.measured_bytes,
                "rounds_saved_ratio": fut.report.rounds_saved_ratio,
                "retries": fut.report.retries,
            }
        return resp

    def _stats(self) -> Dict:
        stats = dict(self.engine.stats())
        stats["pending"] = self.engine.pending
        stats["frontend_requests"] = self.requests_served
        stats["uptime_s"] = time.monotonic() - self.started_s
        # this process's kernel launches (``kernels.ops`` counters)
        stats["launches"] = {**ops.launch_counts(),
                             "pack_ring_masked": ops.pack_ring.masked}
        from ..transport import SocketComm
        sock = comm_lib.find_comm(self.engine.session.comm, SocketComm)
        if sock is not None:
            resilient = comm_lib.find_resilient(self.engine.session.comm)
            stats["transport"] = {
                "party": sock.party,
                "rounds": sock.n_swaps,
                "payload_bytes": sock.bytes_tx,
                "header_bytes": sock.header_bytes,
                "dup_dropped": sock.dup_dropped,
                "retries": resilient.retries if resilient else 0,
                "recovered": resilient.recovered if resilient else 0,
            }
        return stats

    def _healthz(self) -> Dict:
        err = self.engine.last_pump_error
        return {"ok": True, "pending": self.engine.pending,
                "pump": self.engine.pump_running,
                "last_pump_error": repr(err) if err is not None else None}

    # -- the asyncio HTTP server -----------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            status, body = await self._dispatch(reader)
        except errors.ResultTimeout as e:
            status, body = 504, {"error": str(e)}
        except (errors.ReproError, ValueError, KeyError, TypeError) as e:
            status, body = 400, {"error": f"{type(e).__name__}: {e}"}
        except Exception as e:                     # noqa: BLE001 (last line)
            status, body = 500, {"error": f"{type(e).__name__}: {e}"}
        payload = json.dumps(body).encode()
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  500: "Internal Server Error",
                  504: "Gateway Timeout"}.get(status, "")
        writer.write(
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(payload)}\r\n"
            f"Connection: close\r\n\r\n".encode() + payload)
        try:
            await writer.drain()
            writer.close()
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass                                   # client went away

    async def _dispatch(self, reader: asyncio.StreamReader) -> Tuple[int, Dict]:
        request_line = (await reader.readline()).decode("latin-1").strip()
        if not request_line:
            return 400, {"error": "empty request"}
        try:
            method, path, _version = request_line.split(" ", 2)
        except ValueError:
            return 400, {"error": f"malformed request line {request_line!r}"}
        headers: Dict[str, str] = {}
        while True:
            line = (await reader.readline()).decode("latin-1").strip()
            if not line:
                break
            name, _, value = line.partition(":")
            headers[name.strip().lower()] = value.strip()
        path = path.split("?", 1)[0]
        if method == "GET" and path == "/healthz":
            return 200, self._healthz()
        if method == "GET" and path == "/stats":
            return 200, self._stats()
        if method == "POST" and path == "/infer":
            n = int(headers.get("content-length", 0))
            if n > _MAX_BODY:
                return 400, {"error": f"body of {n} bytes exceeds the "
                             f"{_MAX_BODY} byte cap"}
            payload = json.loads((await reader.readexactly(n)).decode()
                                 if n else "{}")
            resp = await asyncio.to_thread(self._infer_blocking, payload)
            self.requests_served += 1
            return 200, resp
        return 404, {"error": f"no route for {method} {path}"}

    async def serve(self, host: str = "127.0.0.1",
                    port: int = 0) -> Tuple[str, int]:
        """Bind and start serving on the running loop; returns (host, port)."""
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(self._handle, host, port)
        return self._server.sockets[0].getsockname()[:2]

    def serve_background(self, host: str = "127.0.0.1",
                         port: int = 0) -> Tuple[str, int]:
        """Run the HTTP server in a daemon thread; returns the bound
        (host, port) once it accepts connections."""
        bound: Dict = {}
        started = threading.Event()

        def _run() -> None:
            async def _main() -> None:
                bound["addr"] = await self.serve(host, port)
                started.set()
                await self._server.serve_forever()

            try:
                asyncio.run(_main())
            except asyncio.CancelledError:
                pass

        self._thread = threading.Thread(target=_run, name="http-frontend",
                                        daemon=True)
        self._thread.start()
        if not started.wait(10.0):
            raise RuntimeError(f"frontend failed to bind {host}:{port}")
        return bound["addr"]

    def run_forever(self, host: str = "127.0.0.1", port: int = 9001) -> None:
        """Blocking entry point."""

        async def _main() -> None:
            addr = await self.serve(host, port)
            print(f"frontend serving on http://{addr[0]}:{addr[1]} "
                  "(POST /infer, GET /healthz, GET /stats)", flush=True)
            await self._server.serve_forever()

        asyncio.run(_main())

    def close(self) -> None:
        """Stop the HTTP server and the engine pump (queued work stays)."""
        if self._server is not None and self._loop is not None:
            self._loop.call_soon_threadsafe(self._server.close)
        if self._thread is not None:
            for task in asyncio.all_tasks(self._loop) if self._loop else []:
                self._loop.call_soon_threadsafe(task.cancel)
            self._thread.join(5.0)
            self._thread = None
        self.engine.stop_pump()


# -- deployment entry point: the leader party process -------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="frontend",
        description="leader party: inference engine + HTTP frontend",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--job", required=True)
    ap.add_argument("--listen", default=None,
                    help="host:port to accept the follower party on")
    ap.add_argument("--peer", default=None,
                    help="host:port of a hosting follower to dial")
    ap.add_argument("--http", default="127.0.0.1:9001",
                    help="host:port for the HTTP frontend")
    ap.add_argument("--party", type=int, default=0, choices=(0, 1))
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=50.0)
    ap.add_argument("--merge-identical", action="store_true")
    ap.add_argument("--rtt-ms", type=float, default=0.0)
    ap.add_argument("--mbps", type=float, default=0.0)
    ap.add_argument("--timeout-s", type=float, default=30.0)
    ap.add_argument("--handshake-timeout-s", type=float, default=120.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device for shares, triples and kernels")
    return ap


def build_engine(args, job):
    """The leader-side engine over a connected two-party session."""
    from .. import api, transport
    from ..device import resolve as resolve_device
    from ..models import resnet
    from ..transport.socket import parse_address
    from .engine import BatchPolicy, InferenceEngine

    device = resolve_device(args.device)
    cfg, plan = job["cfg"], job["plan"]
    params = resnet.init(cfg, seed=job["params_seed"], device=device)
    shaper = None
    if args.rtt_ms > 0 or args.mbps > 0:
        shaper = transport.LinkShaper(
            rtt_s=args.rtt_ms / 1e3,
            bandwidth_bps=(args.mbps * 1e6 if args.mbps > 0
                           else float("inf")))
    session = api.Session.connect(
        args.party,
        listen=parse_address(args.listen) if args.listen else None,
        peer=parse_address(args.peer) if args.peer else None,
        key=job["session_seed"], session_id=str(job["session_seed"]),
        plan_digest=plan.digest(), shaper=shaper, timeout_s=args.timeout_s,
        handshake_timeout_s=args.handshake_timeout_s, device=device)

    def afn(p, v, relu_fn=None):
        return resnet.apply(p, v, cfg, relu_fn=relu_fn)

    engine = InferenceEngine(
        afn, params, cfg, plan, session,
        policy=BatchPolicy(max_batch=args.max_batch,
                           max_wait_s=args.max_wait_ms / 1e3,
                           merge_identical=args.merge_identical),
        provider_factory=transport.tenant_provider_factory(
            job["ttp_seed"], party=args.party, device=device))
    link = transport.EngineLink(engine)
    return engine, link


def main(argv=None) -> int:
    from .. import transport
    from ..transport.socket import parse_address

    args = build_parser().parse_args(argv)
    if (args.listen is None) == (args.peer is None):
        print("pass exactly one of --listen / --peer", file=sys.stderr)
        return 2
    job = transport.load_job(args.job)
    engine, link = build_engine(args, job)
    frontend = Frontend(engine)
    host, port = parse_address(args.http, default_port=9001)
    try:
        frontend.run_forever(host, port)
    except KeyboardInterrupt:
        pass
    finally:
        link.shutdown()
        frontend.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
