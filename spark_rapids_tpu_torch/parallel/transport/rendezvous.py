"""Socket rendezvous for the hostfile shuffle transport (port of the JAX
package's ``parallel/transport/rendezvous.py``).

The spool directory carries the DATA; this module carries the
MEMBERSHIP signal: a committing worker announces "exchange X, worker W
committed" over one short-lived TCP connection, and a reduce-side
fetcher blocks until N distinct workers have committed an exchange, an
event wait in place of manifest-file polling (the metadata round of the
reference's UCX transport, shrunk to one line of text).

Wire protocol (UTF-8 lines, one request a connection), the reference's:

    COMMIT <exchange-tag> <worker-id>\n      -> OK\n
    WAIT <exchange-tag> <n> <timeout-ms>\n   -> OK <k>\n | TIMEOUT <k>\n
    LIST <exchange-tag>\n                    -> OK <w1,w2,...>\n
    PING\n                                   -> OK\n

The server coordinates and never carries shard bytes; losing it only
degrades fetchers to manifest polling. Every client round trip runs
under a connect/read timeout with a bounded retry and deterministic
exponential backoff, so a dead peer fails fast with
:class:`RendezvousUnavailableError` (``UNAVAILABLE:``, the recovery
ladder's transient rung) instead of hanging a fetch. The accept side has
a read timeout too, so a half-open client cannot pin a handler thread.
Unknown verbs go to ``server.dispatch_extra`` (a subclass's extension
point; the base server answers ERR).
"""

from __future__ import annotations

import socket
import socketserver
import threading
import time
import zlib
from typing import Dict, List, Optional, Set, Tuple

_BACKOFF_CAP_S = 2.0


class RendezvousUnavailableError(ConnectionError):
    """A rendezvous peer was unreachable within the bounded retry
    schedule. The ``UNAVAILABLE:`` prefix makes it a transient error to
    the recovery ladder (memory/oom.is_transient_error); the hostfile
    transport additionally catches it and degrades to manifest-file
    polling instead of failing the fetch."""

    def __init__(self, addr: Tuple[str, int], attempts: int,
                 last: BaseException):
        super().__init__(
            f"UNAVAILABLE: rendezvous {addr[0]}:{addr[1]} unreachable "
            f"after {attempts} attempt(s): "
            f"{type(last).__name__}: {last}")
        self.addr = addr
        self.attempts = attempts


class _State:
    def __init__(self):
        self.lock = threading.Condition()
        self.committed: Dict[str, Set[str]] = {}


class _Handler(socketserver.StreamRequestHandler):
    # A dead/half-open client times out its read instead of pinning a
    # handler thread forever (accept-side hardening).
    timeout = 30.0

    def handle(self):
        state: _State = self.server.state        # type: ignore[attr-defined]
        line = self.rfile.readline().decode("utf-8", "replace").strip()
        parts = line.split()
        if not parts:
            return
        cmd = parts[0].upper()
        if cmd == "PING":
            self.wfile.write(b"OK\n")
        elif cmd == "COMMIT" and len(parts) == 3:
            _, tag, worker = parts
            with state.lock:
                state.committed.setdefault(tag, set()).add(worker)
                state.lock.notify_all()
            self.wfile.write(b"OK\n")
        elif cmd == "LIST" and len(parts) == 2:
            with state.lock:
                ws = sorted(state.committed.get(parts[1], ()))
            self.wfile.write(f"OK {','.join(ws)}\n".encode())
        elif cmd == "WAIT" and len(parts) == 4:
            _, tag, n_s, timeout_s = parts
            n, timeout_ms = int(n_s), int(timeout_s)
            deadline = time.monotonic() + timeout_ms / 1000.0
            with state.lock:
                while len(state.committed.get(tag, ())) < n:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    state.lock.wait(min(left, 0.2))
                k = len(state.committed.get(tag, ()))
            ok = b"OK" if k >= n else b"TIMEOUT"
            self.wfile.write(ok + f" {k}\n".encode())
        else:
            # Protocol extension point: a subclassed server serves its
            # extra verbs here; the base server answers ERR.
            resp = self.server.dispatch_extra(parts)    # type: ignore
            self.wfile.write(b"ERR\n" if resp is None else resp)


class _TCPServer(socketserver.ThreadingTCPServer):
    # A restarted server must rebind its fixed port at once after its
    # predecessor was killed; without SO_REUSEADDR the lingering
    # TIME_WAIT sockets make the bind fail with EADDRINUSE.
    allow_reuse_address = True


class RendezvousServer:
    """Threaded TCP rendezvous. ``addr`` is the bound (host, port) —
    pass port 0 to let the OS pick one (tests)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        srv = self._srv = _TCPServer(
            (host, port), _Handler, bind_and_activate=True)
        srv.daemon_threads = True
        srv.state = _State()                  # type: ignore[attr-defined]
        srv.dispatch_extra = self.dispatch_extra  # type: ignore
        self.addr: Tuple[str, int] = srv.server_address[:2]
        self._thread = threading.Thread(
            target=srv.serve_forever, name="srt-torch-rendezvous",
            daemon=True)
        self._thread.start()

    def dispatch_extra(self, parts: List[str]) -> Optional[bytes]:
        """Handle one non-base verb; None = unknown (client gets ERR).
        Subclasses override."""
        return None

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


def _roundtrip(addr: Tuple[str, int], line: str,
               timeout_s: float = 10.0, retries: int = 3,
               backoff_ms: int = 50) -> str:
    """One request/response round trip with bounded retry.

    ``timeout_s`` bounds the connect AND the response read of each
    attempt; a refused/timed-out attempt backs off deterministically
    (``backoff_ms * 2^i``, capped, plus a deterministic jitter derived
    from the request line — so a fleet of clients retrying through one
    coordinator outage desynchronizes instead of stampeding in
    lockstep, without introducing nondeterminism) and retries up to
    ``retries`` extra times before raising
    :class:`RendezvousUnavailableError`.
    """
    attempts = max(int(retries), 0) + 1
    last: Optional[BaseException] = None
    for i in range(attempts):
        if i:
            base = min(backoff_ms * (2 ** (i - 1)) / 1000.0,
                       _BACKOFF_CAP_S)
            jitter = (zlib.crc32(f"{line}|{i}".encode()) % 1000) / 1000.0
            time.sleep(base * (1.0 + 0.25 * jitter))
        try:
            with socket.create_connection(addr, timeout=timeout_s) as s:
                s.sendall(line.encode("utf-8"))
                f = s.makefile("rb")
                return f.readline().decode("utf-8", "replace").strip()
        except (OSError, socket.timeout) as e:
            last = e
    raise RendezvousUnavailableError(addr, attempts, last)


def parse_addr(spec: str) -> Optional[Tuple[str, int]]:
    spec = (spec or "").strip()
    if not spec:
        return None
    host, _, port = spec.rpartition(":")
    return (host or "127.0.0.1", int(port))


def client_params(conf) -> Tuple[float, int, int]:
    """(timeout_s, retries, backoff_ms) for one round trip, from the
    hostfile.rendezvous.* hardening keys."""
    from spark_rapids_tpu_torch import config as C
    return (max(int(conf.get(
                C.SHUFFLE_TRANSPORT_HOSTFILE_RV_CONNECT_TIMEOUT_MS)),
                1) / 1000.0,
            max(int(conf.get(C.SHUFFLE_TRANSPORT_HOSTFILE_RV_RETRIES)),
                0),
            max(int(conf.get(
                C.SHUFFLE_TRANSPORT_HOSTFILE_RV_BACKOFF_MS)), 1))


def announce_commit(addr: Tuple[str, int], tag: str, worker: str,
                    timeout_s: float = 10.0, retries: int = 3,
                    backoff_ms: int = 50) -> None:
    _roundtrip(addr, f"COMMIT {tag} {worker}\n", timeout_s=timeout_s,
               retries=retries, backoff_ms=backoff_ms)


def wait_committed(addr: Tuple[str, int], tag: str, n: int,
                   timeout_ms: int, connect_timeout_s: float = 10.0,
                   retries: int = 3, backoff_ms: int = 50) -> bool:
    """Block until ``n`` workers committed ``tag``; False on timeout."""
    resp = _roundtrip(addr, f"WAIT {tag} {n} {timeout_ms}\n",
                      timeout_s=timeout_ms / 1000.0 + connect_timeout_s,
                      retries=retries, backoff_ms=backoff_ms)
    return resp.startswith("OK")
