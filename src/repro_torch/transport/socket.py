"""SocketComm: the real inter-process party link over TCP (twin of the
reference's ``transport/socket.py``, speaking the same wire protocol).

Every other backend in ``core.comm`` simulates the second party
(``SimComm`` materialises both rows).  ``SocketComm`` is the deployment
backend: each party is its OWN operating-system process holding only its
OWN share rows (local party dimension 1), and ``swap`` is a
length-prefixed framed exchange of the round's flattened word buffer over
a TCP connection.

Wire format (HBTP, little-endian, byte-identical to the reference's), one
message per direction per round::

    +-------+------+-------+-------+---------+---------+----------+
    | magic | kind | party | flags |   seq   | n_bytes | body ... |
    |  4 B  | 1 B  |  1 B  |  2 B  |   4 B   |   4 B   | n_bytes  |
    +-------+------+-------+-------+---------+---------+----------+

kinds: HELLO (handshake json), DATA (one protocol round's payload words),
CTRL (out-of-band json + blob, used by the serving engine link).  A DATA
body is the payload's wire words (``comm.payload_words``: int32 words as
they are, int64 ring values as their low words then their high words),
exactly the bytes the reference's uint32 leaves give, so a JAX party and a
torch party talk to each other.

Contracts that make the stack above work:

- **Byte accounting**: ``round_bytes``/``bytes_tx`` count ONLY the
  protocol payload (the body of DATA messages), what
  ``comm.payload_bytes`` counts for the sim backends and what
  ``Schedule.framed()`` predicts.  The 16-byte envelope is tracked
  separately in ``header_bytes``.
- **Idempotent re-send** (what ``ResilientComm`` needs): a round's DATA
  message carries the sender's round sequence number.  Stale duplicates
  (seq < expected) are dropped; the last few delivered payloads are cached
  so a local retry of an already-delivered round returns the cached bytes
  instead of deadlocking on a peer that will never re-send.
- **Typed failures**: a socket timeout raises ``errors.CommTimeout``
  (retryable), a closed or reset connection ``errors.PartyCrashed`` (not
  retryable: recovery is restart + ``RoundJournal`` resume), a handshake
  identity mismatch ``errors.HandshakeFailed``.
- **Link shaping**: ``LinkShaper(rtt_s, bandwidth_bps)`` paces each round
  to ``rtt + 2 * payload_bytes * 8 / bandwidth``, the per-round term of
  ``Schedule.latency``.
- **Full duplex**: ``swap`` sends its round on a helper thread while it
  receives the peer's.  Both parties send first, so with the reference's
  send-then-receive two rounds larger than the kernel's socket buffers
  (a few MB on loopback; ResNet-18's rounds reach tens of MB) block both
  senders for good; the bytes on the wire are the same either way.
- **Device**: ``swap`` copies the round's words from the buffer's device
  into a pinned host buffer, sends them, receives the peer's, and copies
  those back to the device.  The bytes on the wire never pass through the
  protocol code, so a socket round cannot sit inside a CUDA graph
  (``runtime/loop.compiled_eligible`` keeps such stacks on the generator
  loop).

Handshake: both ends exchange a HELLO naming (protocol version, party
index, session id, plan digest, journal length) and fail loudly on any
identity mismatch.  The journal lengths negotiate the resume round after
a crash: both parties truncate their ``RoundJournal`` to
``min(len_a, len_b)`` (see ``Session.connect``).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import socket as socket_lib
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import errors
from ..core.comm import payload_words, words_payload

MAGIC = b"HBTP"
VERSION = 1
HEADER = struct.Struct("<4sBBHII")      # magic kind party flags seq n_bytes
KIND_HELLO, KIND_DATA, KIND_CTRL = 1, 2, 3
_KIND_NAMES = {KIND_HELLO: "HELLO", KIND_DATA: "DATA", KIND_CTRL: "CTRL"}


def free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port (tests / examples)."""
    with socket_lib.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def parse_address(addr: str, default_port: int = 9000) -> Tuple[str, int]:
    """``"host:port"`` / ``":port"`` / ``"host"`` -> (host, port)."""
    if ":" in addr:
        host, port = addr.rsplit(":", 1)
        return (host or "127.0.0.1", int(port))
    return (addr or "127.0.0.1", default_port)


@dataclasses.dataclass(frozen=True)
class LinkShaper:
    """Injected link profile: each round is paced to the schedule
    simulator's per-round cost, ``rtt_s + 2 * bytes * 8 / bandwidth``
    (both directions ride the link, as ``Schedule.latency`` prices it).
    ``from_preset`` shapes to an ``api.plan.NetworkPreset``."""

    rtt_s: float = 0.0
    bandwidth_bps: float = float("inf")

    @classmethod
    def from_preset(cls, preset) -> "LinkShaper":
        return cls(rtt_s=preset.rtt_s, bandwidth_bps=preset.bandwidth_bps)

    def round_delay(self, payload_bytes: int) -> float:
        bw = (2.0 * payload_bytes * 8.0 / self.bandwidth_bps
              if self.bandwidth_bps != float("inf") else 0.0)
        return self.rtt_s + bw


class SocketComm:
    """Two-party ``Comm`` backend over one TCP connection.

    Construct via :meth:`host` (bind + accept, usually party 0) or
    :meth:`dial` (connect with retry while the peer starts up).  Local
    tensors carry a party dimension of 1, this process's own rows;
    ``swap`` returns the peer's rows in the same (1, ...) layout, on the
    payload's device.

    Mount it at the very bottom of the resilience stack::

        CoalescingComm( JournaledComm( ResilientComm( SocketComm )))

    (``Session.connect`` builds exactly that.)  ``timeout_s`` applies to
    every blocking receive; ``ResilientComm`` owns the retry budget.
    """

    n_parties = 2

    def __init__(self, sock: socket_lib.socket, party: int, *,
                 shaper: Optional[LinkShaper] = None,
                 timeout_s: Optional[float] = None):
        if party not in (0, 1):
            raise ValueError(f"party must be 0 or 1, got {party}")
        self._sock = sock
        self.party = int(party)
        self.shaper = shaper
        self.timeout_s = timeout_s
        sock.setsockopt(socket_lib.IPPROTO_TCP, socket_lib.TCP_NODELAY, 1)
        sock.settimeout(timeout_s)
        self.negotiated: Dict = {}
        #: receive buffer persisting across CommTimeouts: a timeout
        #: mid-message keeps the bytes already read, so a retried recv
        #: resumes the SAME message instead of misparsing the stream
        self._rx_buf = bytearray()
        self._seq = 0                            # completed DATA rounds
        self._ctrl_pending: collections.deque = collections.deque()
        self._recv_cache: "collections.OrderedDict[int, bytearray]" = \
            collections.OrderedDict()
        self.n_swaps = 0
        self.round_bytes: List[int] = []
        self.header_bytes = 0                    # envelope overhead, not wire
        self.dup_dropped = 0

    # -- construction ---------------------------------------------------------
    @classmethod
    def host(cls, bind: Tuple[str, int], *, party: int = 0,
             session: str = "", plan: str = "", journal_len: int = 0,
             shaper: Optional[LinkShaper] = None,
             timeout_s: Optional[float] = None,
             accept_timeout_s: float = 60.0) -> "SocketComm":
        """Bind, accept one peer, handshake."""
        srv = socket_lib.socket()
        srv.setsockopt(socket_lib.SOL_SOCKET, socket_lib.SO_REUSEADDR, 1)
        srv.bind(tuple(bind))
        srv.listen(1)
        srv.settimeout(accept_timeout_s)
        try:
            conn, _ = srv.accept()
        except socket_lib.timeout as e:
            raise errors.HandshakeFailed(
                f"no peer connected to {bind} within "
                f"{accept_timeout_s}s") from e
        finally:
            srv.close()
        comm = cls(conn, party, shaper=shaper, timeout_s=timeout_s)
        comm._handshake(session, plan, journal_len,
                        handshake_timeout_s=accept_timeout_s)
        return comm

    @classmethod
    def dial(cls, peer: Tuple[str, int], *, party: int = 1,
             session: str = "", plan: str = "", journal_len: int = 0,
             shaper: Optional[LinkShaper] = None,
             timeout_s: Optional[float] = None,
             connect_timeout_s: float = 60.0) -> "SocketComm":
        """Connect to a hosting peer, retrying while it starts up."""
        deadline = time.monotonic() + connect_timeout_s
        last: Optional[Exception] = None
        while True:
            try:
                conn = socket_lib.create_connection(
                    tuple(peer), timeout=max(0.1, deadline - time.monotonic()))
                break
            except OSError as e:
                last = e
                if time.monotonic() >= deadline:
                    raise errors.HandshakeFailed(
                        f"could not reach peer at {peer} within "
                        f"{connect_timeout_s}s: {last}") from e
                time.sleep(0.05)
        comm = cls(conn, party, shaper=shaper, timeout_s=timeout_s)
        comm._handshake(session, plan, journal_len,
                        handshake_timeout_s=connect_timeout_s)
        return comm

    def _handshake(self, session: str, plan: str, journal_len: int,
                   handshake_timeout_s: float) -> None:
        hello = {"version": VERSION, "party": self.party,
                 "session": str(session), "plan": str(plan),
                 "journal": int(journal_len)}
        self._send(KIND_HELLO, 0, json.dumps(hello).encode())
        self._sock.settimeout(handshake_timeout_s)
        try:
            kind, _, _, body = self._recv_msg()
        except errors.CommError as e:
            raise errors.HandshakeFailed(f"handshake failed: {e}") from e
        finally:
            self._sock.settimeout(self.timeout_s)
        if kind != KIND_HELLO:
            raise errors.HandshakeFailed(
                f"expected HELLO, got {_KIND_NAMES.get(kind, kind)}")
        peer = json.loads(bytes(body).decode())
        if peer.get("version") != VERSION:
            raise errors.HandshakeFailed(
                f"protocol version mismatch: local {VERSION}, "
                f"peer {peer.get('version')}")
        if peer.get("party") != 1 - self.party:
            raise errors.HandshakeFailed(
                f"party collision: both ends claim party index "
                f"{self.party}" if peer.get("party") == self.party else
                f"unexpected peer party {peer.get('party')}")
        if peer.get("session") != str(session):
            raise errors.HandshakeFailed(
                f"session mismatch: local {session!r}, "
                f"peer {peer.get('session')!r}: the two parties were "
                "launched with different session seeds")
        if peer.get("plan") != str(plan):
            raise errors.HandshakeFailed(
                f"plan mismatch: local digest {plan!r}, peer "
                f"{peer.get('plan')!r}: the two parties would replay "
                "different networks")
        self.negotiated = {
            "peer_party": int(peer["party"]),
            "session": str(session),
            "plan": str(plan),
            "journal_len": int(journal_len),
            "peer_journal_len": int(peer.get("journal", 0)),
            "resume_round": min(int(journal_len),
                                int(peer.get("journal", 0))),
        }

    # -- raw messaging --------------------------------------------------------
    def _send(self, kind: int, seq: int, body) -> None:
        body = memoryview(body).cast("B")
        msg = bytearray(HEADER.size + body.nbytes)
        HEADER.pack_into(msg, 0, MAGIC, kind, self.party, 0, seq & 0xFFFFFFFF,
                         body.nbytes)
        msg[HEADER.size:] = body
        try:
            self._sock.sendall(msg)
        except socket_lib.timeout as e:
            raise errors.CommTimeout(f"socket send stalled: {e}") from e
        except OSError as e:
            raise errors.PartyCrashed(f"peer connection lost: {e}") from e
        self.header_bytes += HEADER.size

    def _send_async(self, kind: int, seq: int, body):
        """``_send`` on a helper thread; join it with ``_joined``."""
        box: Dict = {}

        def run():
            try:
                self._send(kind, seq, body)
            except BaseException as e:       # noqa: BLE001 (re-raised)
                box["error"] = e

        box["thread"] = threading.Thread(target=run, daemon=True)
        box["thread"].start()
        return box

    @staticmethod
    def _joined(box) -> None:
        """Wait for a ``_send_async`` send; re-raise its failure."""
        box["thread"].join()
        if "error" in box:
            raise box["error"]

    def _fill(self, n: int) -> None:
        """Grow the receive buffer to at least n bytes (resumable: a
        timeout keeps everything read so far)."""
        while len(self._rx_buf) < n:
            try:
                chunk = self._sock.recv(1 << 22)
            except socket_lib.timeout as e:
                raise errors.CommTimeout(
                    f"socket recv stalled past {self._sock.gettimeout()}s "
                    f"({len(self._rx_buf)}/{n} bytes buffered)") from e
            except OSError as e:
                raise errors.PartyCrashed(
                    f"peer connection lost: {e}") from e
            if not chunk:
                raise errors.PartyCrashed(
                    f"peer closed the connection "
                    f"({len(self._rx_buf)}/{n} bytes of a message)")
            self._rx_buf.extend(chunk)

    def _recv_msg(self) -> Tuple[int, int, int, bytearray]:
        self._fill(HEADER.size)
        magic, kind, party, _flags, seq, n = HEADER.unpack_from(self._rx_buf)
        if magic != MAGIC:
            raise errors.PayloadCorrupted(
                f"bad message magic {magic!r} (stream desynchronised)")
        self._fill(HEADER.size + n)
        body = self._rx_buf[HEADER.size:HEADER.size + n]
        del self._rx_buf[:HEADER.size + n]
        return kind, party, seq, body

    def _recv_data(self, expect_seq: int) -> bytearray:
        if expect_seq in self._recv_cache:
            # a local retry of a round TCP already delivered: serve the
            # cached payload (the peer advanced and will never re-send)
            return self._recv_cache[expect_seq]
        while True:
            kind, _, seq, body = self._recv_msg()
            if kind == KIND_CTRL:
                self._ctrl_pending.append(body)
                continue
            if kind != KIND_DATA:
                raise errors.PayloadCorrupted(
                    f"expected DATA, got {_KIND_NAMES.get(kind, kind)}")
            if seq == expect_seq:
                self._recv_cache[seq] = body
                while len(self._recv_cache) > 8:
                    self._recv_cache.popitem(last=False)
                return body
            if seq < expect_seq:                 # peer's idempotent re-send
                self.dup_dropped += 1
                continue
            raise errors.PayloadCorrupted(
                f"round desync: peer sent round {seq}, this party expects "
                f"{expect_seq}")

    # -- the Comm interface ---------------------------------------------------
    @property
    def n_rounds(self) -> int:
        return self.n_swaps

    @property
    def bytes_tx(self) -> int:
        return sum(self.round_bytes)

    @staticmethod
    def _host_words(n: int, device: torch.device) -> torch.Tensor:
        """A host buffer of ``n`` int32 words, pinned (from torch's caching
        host allocator) for a CUDA payload."""
        return torch.empty(n, dtype=torch.int32, pin_memory=device.type == "cuda")

    def swap(self, x: torch.Tensor) -> torch.Tensor:
        """One protocol round: send this party's rows, return the peer's.

        The payload is int32 words or int64 ring values with a local party
        dimension of 1 (this process holds only its own shares).  Retrying
        after a ``CommTimeout`` re-enters with the same sequence number:
        the re-send is idempotent and an already-delivered peer payload is
        served from the receive cache.
        """
        if x.dtype not in (torch.int32, torch.int64):
            raise TypeError("SocketComm payloads must be int32 words or int64 "
                            f"ring values, got {x.dtype}")
        if x.shape[0] != 1:
            raise TypeError(
                "SocketComm is a per-process party backend: payloads carry a "
                f"local party dim of 1, got shape {tuple(x.shape)}")
        t0 = time.monotonic()
        words = payload_words(x)
        n = sum(w.shape[1] for w in words)
        host = self._host_words(n, x.device)
        off = 0
        for w in words:
            host[off:off + w.shape[1]].copy_(w.reshape(-1))
            off += w.shape[1]
        sending = self._send_async(KIND_DATA, self._seq, host.numpy())
        try:
            data = self._recv_data(self._seq)
        finally:
            sending["thread"].join()
        self._joined(sending)
        if len(data) != 4 * n:
            raise errors.PayloadCorrupted(
                f"round {self._seq}: peer sent {len(data)} payload bytes, "
                f"expected {4 * n} (mismatched executions)")
        if self.shaper is not None:
            target = t0 + self.shaper.round_delay(4 * n)
            now = time.monotonic()
            if target > now:
                time.sleep(target - now)
        self._seq += 1
        self.n_swaps += 1
        self.round_bytes.append(4 * n)
        rx = self._host_words(n, x.device)
        rx.numpy()[:] = np.frombuffer(data, np.int32)
        peer = torch.empty((1, n), dtype=torch.int32, device=x.device)
        peer.view(-1).copy_(rx)
        return words_payload(peer, x)

    def party_is(self, p: int, template: torch.Tensor) -> torch.Tensor:
        return torch.full((1,) * max(1, template.ndim), p == self.party,
                          dtype=torch.bool, device=template.device)

    def party_slice(self, full: torch.Tensor) -> torch.Tensor:
        """This party's rows of a full (n_parties, ...) tensor."""
        return full[self.party:self.party + 1]

    # -- out-of-band control channel (serving engine link) --------------------
    def send_ctrl(self, obj: Dict, blob: bytes = b"") -> None:
        """One CTRL message: a json header plus an opaque binary blob."""
        hdr = json.dumps(obj).encode()
        self._send(KIND_CTRL, 0, struct.pack("<I", len(hdr)) + hdr + bytes(blob))

    def recv_ctrl(self,
                  timeout_s: Optional[float] = ...) -> Tuple[Dict, bytes]:
        """Next CTRL message (skipping any stale DATA re-sends)."""
        if timeout_s is not ...:
            self._sock.settimeout(timeout_s)
        try:
            while not self._ctrl_pending:
                kind, _, seq, body = self._recv_msg()
                if kind == KIND_CTRL:
                    self._ctrl_pending.append(body)
                elif kind == KIND_DATA and seq < self._seq:
                    self.dup_dropped += 1        # stale re-send, drop
                else:
                    raise errors.PayloadCorrupted(
                        f"expected CTRL, got "
                        f"{_KIND_NAMES.get(kind, kind)} seq {seq} while "
                        f"at round {self._seq}")
        finally:
            if timeout_s is not ...:
                self._sock.settimeout(self.timeout_s)
        body = bytes(self._ctrl_pending.popleft())
        (n,) = struct.unpack_from("<I", body)
        hdr = json.loads(body[4:4 + n].decode())
        return hdr, body[4 + n:]

    def close(self) -> None:
        try:
            self._sock.shutdown(socket_lib.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    def __enter__(self) -> "SocketComm":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
