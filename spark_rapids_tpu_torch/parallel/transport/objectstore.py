"""Object-store shuffle transport: the cross-machine data plane (port of
the JAX package's ``parallel/transport/objectstore.py``).

The contract of ``hostfile`` (CRC-framed shard blobs from
``memory/stores.batch_to_shard_blob``, a manifest as the publication
barrier, refetch-once-then-stage-recompute on corruption, an
owner-tagged :class:`ShardLostError` on loss) keyed into a flat object
namespace behind a pluggable :class:`ObjectStoreBackend` instead of paths
on a shared filesystem::

    <prefix>/<exchange-tag>/<worker>/p00003-0001.shard
    <prefix>/<exchange-tag>/<worker>.manifest.json
    <prefix>/<exchange-tag>/exchange.manifest.json   (exclusive mode)

The manifest PUT is the atomicity contract: an object store serves whole
objects, so a fetcher sees the previous complete manifest or the new one,
never a torn mix (the object-namespace analog of ``os.replace``).

What it adds over hostfile is the failure model of a remote store:

- every backend request (put/get/list/delete) runs under bounded retry
  with exponential backoff and DETERMINISTIC jitter (from the object key
  and the attempt), counter ``objectstoreRetries``; exhausted retries
  raise a typed 'UNAVAILABLE:' error, the transient rung of the
  recovery ladder;
- a 404 on a manifest-listed shard is not retried: that shard is gone,
  and the owner-tagged :class:`ShardLostError` routes to ONE stage
  recompute;
- fault kinds: ``unavailable@objectstore`` fails one backend request
  (absorbed by the retry loop), ``slowput@transport`` delays a shard
  write, and the hostfile kinds (``lostshard`` / ``corrupt`` / ``oom`` /
  ``transient`` at ``transport``) apply unchanged at the fetch funnel.

The shipped backend is :class:`HttpObjectStoreBackend` (stdlib urllib)
against the localhost stub server in this module, which injects latency,
5xx bursts and shard loss through an admin endpoint (``POST
/admin/latency?ms=``, ``/admin/fail?n=&code=``, ``/admin/drop?prefix=``,
``/admin/reset``). With no endpoint configured, an in-process stub is
started once a process.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from spark_rapids_tpu_torch.parallel.transport.base import (
    ShardLostError, ShuffleSession, ShuffleTransport)
from spark_rapids_tpu_torch.parallel.transport.hostfile import (
    ShardHandle, fetch_with_refetch, valid_manifest)

_LOG = logging.getLogger("spark_rapids_tpu_torch.transport")

_BACKOFF_CAP_S = 2.0


class ObjectStoreUnavailableError(RuntimeError):
    """The backend failed TRANSIENTLY (5xx, refused/reset connection,
    socket timeout) and bounded retry was exhausted. Typed
    'UNAVAILABLE:' so it lands on the transient rung of the recovery
    ladder: the store being down is not shard loss, and a stage
    recompute against the same dead store would not help."""

    def __init__(self, what: str):
        super().__init__(f"UNAVAILABLE: object store: {what}")


class ObjectMissingError(KeyError):
    """GET/DELETE of a key the store does not have (HTTP 404). Distinct
    from unavailability: for a manifest-listed shard this is LOSS and
    goes to stage recompute, not retry."""


# -- backend SPI --------------------------------------------------------------

class ObjectStoreBackend:
    """Minimal put/get/list/delete object SPI. Implementations raise
    :class:`ObjectStoreUnavailableError` for transient faults (the
    session retries those) and :class:`ObjectMissingError` for a
    definitive 404 (the session maps it to loss). One instance may be
    shared across sessions and threads."""

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        """Must be idempotent: deleting a missing key is not an error."""
        raise NotImplementedError

    def list_keys(self, prefix: str) -> List[str]:
        raise NotImplementedError


class HttpObjectStoreBackend(ObjectStoreBackend):
    """Backend over the stub server's HTTP surface (PUT/GET/DELETE
    ``/o/<key>``, GET ``/list?prefix=``) via stdlib urllib — no new
    dependencies. Any real S3/GCS-compatible gateway exposing the same
    four verbs slots in behind :func:`register_backend`."""

    def __init__(self, endpoint: str, timeout_s: float = 5.0):
        self.endpoint = endpoint.rstrip("/")
        self.timeout_s = timeout_s

    def _url(self, key: str) -> str:
        return f"{self.endpoint}/o/{urllib.parse.quote(key, safe='/')}"

    def _request(self, method: str, url: str,
                 data: Optional[bytes] = None) -> bytes:
        req = urllib.request.Request(url, data=data, method=method)
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise ObjectMissingError(url) from e
            raise ObjectStoreUnavailableError(
                f"{method} {url}: HTTP {e.code}") from e
        except (urllib.error.URLError, ConnectionError, socket.timeout,
                TimeoutError, OSError) as e:
            raise ObjectStoreUnavailableError(
                f"{method} {url}: {e}") from e

    def put(self, key: str, data: bytes) -> None:
        self._request("PUT", self._url(key), data=data)

    def get(self, key: str) -> bytes:
        return self._request("GET", self._url(key))

    def delete(self, key: str) -> None:
        try:
            self._request("DELETE", self._url(key))
        except ObjectMissingError:
            pass

    def list_keys(self, prefix: str) -> List[str]:
        q = urllib.parse.urlencode({"prefix": prefix})
        body = self._request("GET", f"{self.endpoint}/list?{q}")
        return list(json.loads(body.decode("utf-8")))


_BACKENDS = {"http": HttpObjectStoreBackend}


def register_backend(scheme: str, cls) -> None:
    """Register a backend class for an endpoint scheme (the plugin
    point for a real store)."""
    _BACKENDS[scheme] = cls


def make_backend(endpoint: str, timeout_s: float) -> ObjectStoreBackend:
    scheme = urllib.parse.urlsplit(endpoint).scheme or "http"
    cls = _BACKENDS.get(scheme, _BACKENDS.get("http"))
    if scheme == "https":
        cls = _BACKENDS["http"]
    return cls(endpoint, timeout_s=timeout_s)


# -- localhost stub server ----------------------------------------------------

class _StubState:
    def __init__(self):
        self.lock = threading.Lock()
        self.objects: Dict[str, bytes] = {}
        self.latency_ms = 0
        self.fail_remaining = 0
        self.fail_code = 503
        self.puts = 0
        self.gets = 0
        self.failed = 0


class _StubHandler(BaseHTTPRequestHandler):
    server_version = "srt-torch-objstore/1"

    def log_message(self, fmt, *args):  # pragma: no cover - quiet
        pass

    @property
    def _state(self) -> _StubState:
        return self.server.state  # type: ignore[attr-defined]

    def _reply(self, code: int, body: bytes = b"",
               ctype: str = "application/octet-stream") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _inject(self) -> bool:
        """Data-plane fault injection (admin surface is exempt so chaos
        tests can always steer the stub). Returns True if this request
        was failed."""
        st = self._state
        with st.lock:
            latency = st.latency_ms
            if st.fail_remaining > 0:
                st.fail_remaining -= 1
                st.failed += 1
                code = st.fail_code
            else:
                code = 0
        if latency:
            time.sleep(latency / 1000.0)
        if code:
            self._reply(code, b"injected failure", "text/plain")
            return True
        return False

    def _key(self) -> Optional[str]:
        path = urllib.parse.urlsplit(self.path).path
        if not path.startswith("/o/"):
            return None
        return urllib.parse.unquote(path[len("/o/"):])

    def do_PUT(self):
        key = self._key()
        if key is None:
            return self._reply(400, b"bad path", "text/plain")
        if self._inject():
            return
        n = int(self.headers.get("Content-Length", "0"))
        data = self.rfile.read(n)
        st = self._state
        with st.lock:
            st.objects[key] = data
            st.puts += 1
        self._reply(200)

    def do_GET(self):
        split = urllib.parse.urlsplit(self.path)
        if split.path == "/health":
            return self._reply(200, b"ok", "text/plain")
        if split.path == "/admin/stats":
            st = self._state
            with st.lock:
                body = json.dumps({
                    "keys": len(st.objects), "puts": st.puts,
                    "gets": st.gets, "failed": st.failed,
                    "fail_remaining": st.fail_remaining,
                    "latency_ms": st.latency_ms}).encode()
            return self._reply(200, body, "application/json")
        if split.path == "/list":
            if self._inject():
                return
            prefix = urllib.parse.parse_qs(split.query).get(
                "prefix", [""])[0]
            st = self._state
            with st.lock:
                keys = sorted(k for k in st.objects
                              if k.startswith(prefix))
            return self._reply(200, json.dumps(keys).encode(),
                               "application/json")
        key = self._key()
        if key is None:
            return self._reply(400, b"bad path", "text/plain")
        if self._inject():
            return
        st = self._state
        with st.lock:
            data = st.objects.get(key)
            st.gets += 1
        if data is None:
            return self._reply(404, b"no such object", "text/plain")
        self._reply(200, data)

    def do_DELETE(self):
        key = self._key()
        if key is None:
            return self._reply(400, b"bad path", "text/plain")
        if self._inject():
            return
        st = self._state
        with st.lock:
            st.objects.pop(key, None)
        self._reply(200)

    def do_POST(self):
        """Admin surface: /admin/latency?ms=N, /admin/fail?n=N[&code=C],
        /admin/drop?prefix=K (exact key or prefix), /admin/reset."""
        split = urllib.parse.urlsplit(self.path)
        q = {k: v[0] for k, v in
             urllib.parse.parse_qs(split.query).items()}
        st = self._state
        if split.path == "/admin/latency":
            with st.lock:
                st.latency_ms = int(q.get("ms", "0"))
            return self._reply(200)
        if split.path == "/admin/fail":
            with st.lock:
                st.fail_remaining = int(q.get("n", "1"))
                st.fail_code = int(q.get("code", "503"))
            return self._reply(200)
        if split.path == "/admin/drop":
            prefix = q.get("prefix", "")
            with st.lock:
                dropped = [k for k in st.objects
                           if k == prefix or k.startswith(prefix)]
                for k in dropped:
                    del st.objects[k]
            return self._reply(200, json.dumps(dropped).encode(),
                               "application/json")
        if split.path == "/admin/reset":
            with st.lock:
                st.objects.clear()
                st.latency_ms = 0
                st.fail_remaining = 0
            return self._reply(200)
        self._reply(404, b"no such admin op", "text/plain")


class ObjectStoreStub:
    """In-process localhost object store for tests/CI: a threading HTTP
    server over an in-memory key space, with an admin endpoint for
    injecting latency, 5xx bursts, and shard loss. NOT a durability
    stand-in — it exists so the transport's retry/loss machinery can be
    exercised against real sockets."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.state = _StubState()
        self._httpd = ThreadingHTTPServer((host, port), _StubHandler)
        self._httpd.daemon_threads = True
        self._httpd.state = self.state  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="srt-torch-objstore-stub", daemon=True)
        self._thread.start()

    @property
    def endpoint(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    # Direct steering for in-process tests (the HTTP admin surface
    # drives the same state for out-of-process chaos).
    def set_latency(self, ms: int) -> None:
        with self.state.lock:
            self.state.latency_ms = int(ms)

    def fail_next(self, n: int, code: int = 503) -> None:
        with self.state.lock:
            self.state.fail_remaining = int(n)
            self.state.fail_code = int(code)

    def drop(self, prefix: str) -> List[str]:
        with self.state.lock:
            dropped = [k for k in self.state.objects
                       if k == prefix or k.startswith(prefix)]
            for k in dropped:
                del self.state.objects[k]
        return dropped

    def keys(self, prefix: str = "") -> List[str]:
        with self.state.lock:
            return sorted(k for k in self.state.objects
                          if k.startswith(prefix))

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


_STUB_LOCK = threading.Lock()
_LOCAL_STUB: Optional[ObjectStoreStub] = None


def ensure_local_stub() -> ObjectStoreStub:
    """The per-process fallback stub (started once, daemon threads):
    what an unconfigured endpoint resolves to, so a single-process run
    works with no setup."""
    global _LOCAL_STUB
    with _STUB_LOCK:
        if _LOCAL_STUB is None:
            _LOCAL_STUB = ObjectStoreStub()
            _LOG.info("started in-process object-store stub at %s",
                      _LOCAL_STUB.endpoint)
        return _LOCAL_STUB


def stop_local_stub() -> None:
    global _LOCAL_STUB
    with _STUB_LOCK:
        if _LOCAL_STUB is not None:
            _LOCAL_STUB.close()
            _LOCAL_STUB = None


def resolve_endpoint(conf) -> str:
    """Endpoint selection: conf key > SRT_OBJECTSTORE_ENDPOINT env >
    the in-process stub."""
    from spark_rapids_tpu_torch import config as C
    ep = str(conf.get(C.SHUFFLE_TRANSPORT_OBJECTSTORE_ENDPOINT) or "") \
        .strip()
    if not ep:
        ep = os.environ.get("SRT_OBJECTSTORE_ENDPOINT", "").strip()
    if not ep:
        ep = ensure_local_stub().endpoint
    return ep


# -- session ------------------------------------------------------------------

class ObjectStoreSession(ShuffleSession):
    """One exchange materialization against the object store, with
    HostFileSession's surface (exclusive-manifest mode included)."""

    def __init__(self, conf, tag: str, num_partitions: int,
                 owner: Optional[int], catalog, metrics, device):
        super().__init__(tag, owner)
        from spark_rapids_tpu_torch import config as C
        self._catalog = catalog
        self._metrics = metrics
        # Where fetched shards decode (None: the CUDA card).
        self.device = device
        self.num_partitions = num_partitions
        prefix = str(conf.get(
            C.SHUFFLE_TRANSPORT_OBJECTSTORE_PREFIX) or "").strip("/")
        self.worker = str(conf.get(
            C.SHUFFLE_TRANSPORT_OBJECTSTORE_WORKER_ID) or "") \
            or f"w{os.getpid()}"
        self.exclusive = bool(conf.get(
            C.SHUFFLE_TRANSPORT_OBJECTSTORE_EXCLUSIVE_MANIFEST))
        self.expected_workers = 1 if self.exclusive else max(int(conf.get(
            C.SHUFFLE_TRANSPORT_OBJECTSTORE_EXPECTED_WORKERS)), 1)
        self.fetch_timeout_ms = int(conf.get(
            C.SHUFFLE_TRANSPORT_OBJECTSTORE_FETCH_TIMEOUT_MS))
        self.retries = max(int(conf.get(
            C.SHUFFLE_TRANSPORT_OBJECTSTORE_RETRIES)), 0)
        self.backoff_ms = max(int(conf.get(
            C.SHUFFLE_TRANSPORT_OBJECTSTORE_BACKOFF_MS)), 1)
        timeout_s = max(int(conf.get(
            C.SHUFFLE_TRANSPORT_OBJECTSTORE_TIMEOUT_MS)), 100) / 1000.0
        self.endpoint = resolve_endpoint(conf)
        self.backend = make_backend(self.endpoint, timeout_s=timeout_s)
        # The key namespace root of this exchange's durable output.
        # Cluster session roles, as a hostfile session's.
        self.fetch_only = False
        self.keep_on_close = False
        self.root = f"{prefix}/{tag}" if prefix else tag
        self._seq: Dict[int, int] = {}
        self._written: Dict[int, List[dict]] = {}
        self._committed = False
        self._manifests: Optional[List[dict]] = None
        self._handles: Dict[int, List[ShardHandle]] = {}

    def _manifest_key(self) -> str:
        name = "exchange.manifest.json" if self.exclusive else \
            f"{self.worker}.manifest.json"
        return f"{self.root}/{name}"

    # -- bounded retry --------------------------------------------------------
    def _call(self, op: str, key: str, fn):
        """One backend request under bounded retry: exponential backoff
        (backoffMs * 2^(i-1), capped at 2 s) plus a deterministic jitter
        from (key, attempt). Exhausted retries raise the typed
        UNAVAILABLE error."""
        from spark_rapids_tpu_torch import faults
        from spark_rapids_tpu_torch.parallel import transport as T
        last: Optional[ObjectStoreUnavailableError] = None
        for attempt in range(self.retries + 1):
            if attempt:
                base = min(self.backoff_ms * (2 ** (attempt - 1)) /
                           1000.0, _BACKOFF_CAP_S)
                jitter = (zlib.crc32(f"{key}|{attempt}".encode())
                          % 1000) / 1000.0
                time.sleep(base * (1.0 + 0.5 * jitter))
                T.record("objectstoreRetries")
            try:
                if faults.check_fault("objectstore",
                                      ("unavailable",)) is not None:
                    raise ObjectStoreUnavailableError(
                        f"injected unavailable ({op} {key})")
                return fn()
            except ObjectStoreUnavailableError as err:
                last = err
                _LOG.warning("object store %s %s failed transiently "
                             "(attempt %d/%d): %s", op, key, attempt + 1,
                             self.retries + 1, err)
        raise last

    def _delete_prefix(self, prefix: str) -> None:
        """Best-effort namespace cleanup (invalidate, close): a store
        outage during cleanup never fails the query."""
        try:
            keys = self._call("list", prefix,
                              lambda: self.backend.list_keys(prefix))
            for k in keys:
                self._call("delete", k, lambda k=k: self.backend.delete(k))
        except ObjectStoreUnavailableError as e:
            _LOG.warning("object store cleanup of %s skipped: %s",
                         prefix, e)

    # -- map side ------------------------------------------------------------
    def write_shard(self, partition: int, batch) -> None:
        from spark_rapids_tpu_torch import faults
        from spark_rapids_tpu_torch.memory.stores import batch_to_shard_blob
        from spark_rapids_tpu_torch.parallel import transport as T
        faults.fault_point("transport.write", owner=self.owner)
        if faults.check_fault("transport", ("slowput",)) is not None:
            # An injected slow writer: fetchers keep polling, nothing is
            # visible until the manifest PUT; latency, never an error.
            T.record("slowPuts")
            time.sleep(0.25)
        blob = batch_to_shard_blob(batch)
        seq = self._seq.get(partition, 0)
        self._seq[partition] = seq + 1
        fname = f"p{partition:05d}-{seq:04d}.shard"
        key = f"{self.root}/{self.worker}/{fname}"
        self._call("put", key, lambda: self.backend.put(key, blob))
        rows = batch.rows_hint
        self.record_shard_bytes(partition, len(blob))
        self._written.setdefault(partition, []).append(
            {"file": f"{self.worker}/{fname}",
             "capacity": int(batch.capacity),
             "rows": None if rows is None else int(rows),
             "bytes": len(blob)})
        T.record("transportBytesWritten", len(blob))
        T.record("transportShardsWritten")
        if self._metrics is not None:
            self._metrics.add("transportBytesWritten", len(blob))
            self._metrics.add("transportShardsWritten", 1)

    def commit(self) -> None:
        manifest = {"worker": self.worker,
                    "num_partitions": self.num_partitions,
                    "shards": {str(p): entries
                               for p, entries in self._written.items()}}
        blob = json.dumps(manifest).encode("utf-8")
        key = self._manifest_key()
        # The whole-object PUT is the publication barrier: the shard
        # objects are durable already, but no fetcher reads them before
        # this manifest exists, and a recompute's commit replaces it.
        self._call("put", key, lambda: self.backend.put(key, blob))
        self._committed = True

    # -- reduce side ---------------------------------------------------------
    def _read_manifests(self) -> List[dict]:
        out = []
        prefix = f"{self.root}/"
        keys = self._call("list", prefix,
                          lambda: self.backend.list_keys(prefix))
        for k in keys:
            name = k[len(prefix):]
            if "/" in name or not name.endswith(".manifest.json"):
                continue
            if self.exclusive and name != "exchange.manifest.json":
                continue
            try:
                m = json.loads(self._call(
                    "get", k, lambda k=k: self.backend.get(k)).decode("utf-8"))
            except (ObjectMissingError, ValueError):
                continue          # a racing writer or cleanup: poll again
            if valid_manifest(m):
                out.append(m)
        return out

    def _load_manifests(self) -> List[dict]:
        if self._manifests is not None:
            return self._manifests
        deadline = time.monotonic() + self.fetch_timeout_ms / 1000.0
        while True:
            manifests = self._read_manifests()
            if len(manifests) >= self.expected_workers:
                break
            if time.monotonic() >= deadline:
                raise ShardLostError(
                    f"exchange {self.tag}: {len(manifests)}/"
                    f"{self.expected_workers} worker manifests under "
                    f"{self.endpoint}/{self.root} after "
                    f"{self.fetch_timeout_ms}ms", owner=self.owner)
            time.sleep(0.02)
        manifests.sort(key=lambda m: str(m.get("worker", "")))
        self._manifests = manifests
        return manifests

    def fetch_shards(self, partition: int):
        handles = self._handles.get(partition)
        if handles is None:
            handles = []
            for m in self._load_manifests():
                for entry in m.get("shards", {}).get(str(partition), []):
                    handles.append(ShardHandle(
                        self, f"{self.root}/{entry['file']}",
                        int(entry["capacity"]), entry.get("rows")))
            self._handles[partition] = handles
        return handles

    def _read(self, key: str) -> bytes:
        from spark_rapids_tpu_torch.parallel import transport as T
        try:
            return self._call("get", key, lambda: self.backend.get(key))
        except ObjectMissingError as err:
            T.record("remoteShardsLost")
            raise ShardLostError(f"{key}: object missing",
                                 owner=self.owner) from err

    def _drop_at_rest(self, key: str) -> None:
        try:
            self._call("delete", key, lambda: self.backend.delete(key))
        except ObjectStoreUnavailableError:
            pass

    def _fetch_blob(self, key: str):
        """GET, CRC-verify and decode one shard object (the fetch funnel,
        ``hostfile.fetch_with_refetch``)."""
        return fetch_with_refetch(self, key, lambda: self._read(key))

    # -- lifecycle -----------------------------------------------------------
    def release_partition(self, partition: int) -> None:
        for h in self._handles.pop(partition, []):
            h.close()

    def _close_handles(self) -> None:
        for hs in self._handles.values():
            for h in hs:
                h.close()
        self._handles = {}
        self._manifests = None

    def invalidate(self) -> None:
        """The stage recompute contract: drop the WHOLE durable output
        under the tag (a fetch-only session: its own caches only)."""
        self._close_handles()
        if self.fetch_only:
            return
        self._delete_prefix(f"{self.root}/")
        self._written = {}
        self._seq = {}
        self._committed = False

    def close(self) -> None:
        """Query teardown: release fetched handles and delete what THIS
        worker wrote, and its manifest once committed (a fetch-only or
        keep_on_close session: its handles only)."""
        self._close_handles()
        if self.fetch_only or self.keep_on_close:
            return
        self._delete_prefix(f"{self.root}/{self.worker}/")
        if self._committed or not self.exclusive:
            self._drop_at_rest(self._manifest_key())


class ObjectStoreTransport(ShuffleTransport):
    name = "objectstore"

    def open(self, conf, tag: str, num_partitions: int,
             owner: Optional[int] = None, catalog=None, metrics=None,
             device=None) -> ObjectStoreSession:
        return ObjectStoreSession(conf, tag, num_partitions, owner,
                                  catalog, metrics, device)
