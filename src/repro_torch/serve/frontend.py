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
- ``GET /stats``   ``engine.stats()`` plus the frontend's counters.

The output is revealed and copied to the host under the engine's
``device_lock``, so a worker thread never touches the device while the
pump captures a new stream signature's CUDA graph.  The reference's
deployment CLI (``build_parser``, ``build_engine``, ``main``: a leader
party over a socket transport) waits for the transport's port (ROADMAP
queue 1, item 7).
"""
from __future__ import annotations

import asyncio
import json
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from .. import errors

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
        # the socket transport's wire counters ("transport") join once its
        # SocketComm is ported (ROADMAP queue 1, item 7)
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
