"""Port parity: the shuffle transport SPI (``parallel/transport/``), as
``tests/test_transport.py`` and ``tests/test_objectstore.py`` pin the JAX
package's (its broadcast-cache and cluster cases are in
``tests/test_torch_cluster.py``).

- Selection: conf key, env, the legacy mesh key; ``mesh`` makes the
  collective path's durable half and materializes the other exchanges
  ``inprocess``, and a mesh query plans its hash repartition as
  ``MeshExchangeExec``; a third party registers; every transport key has
  the reference's name and default.
- The shard wire format: a bit-exact round trip, a CRC mismatch raises,
  a blob written by either package decodes in the other to the same
  rows, onto the reading session's device.
- Hostfile: spool, manifest as the publication barrier, owner-tagged
  loss, one refetch on a CRC mismatch then an owner-tagged raise, the
  torn-manifest guard, invalidate, the rendezvous protocol and its
  degrade to polling; two worker processes map-write and this process
  fetches their union.
- Objectstore against ``ObjectStoreStub``: the backend verbs, typed 5xx,
  the admin surface, the manifest barrier, bounded retry through 5xx
  bursts, exhaustion, loss at rest, refetch, and the injected kinds.
- End to end: a shuffled join + aggregate at 4 partitions through
  ``inprocess``, ``hostfile``, ``objectstore`` and ``mesh`` returns the
  reference's rows; a lost shard (``lostshard@transport``) and a shard
  file deleted under a running query are recomputed by their owner
  stage with the same rows; a corrupt shard is refetched; the spool and
  the store are empty after the query.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)

import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from spark_rapids_tpu import config as JC
from spark_rapids_tpu.api.dataframe import TpuSession as JSession
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu.columnar.host import device_to_host as jd2h
from spark_rapids_tpu.columnar.host import host_to_device as jh2d
from spark_rapids_tpu.memory import stores as jstores
from spark_rapids_tpu.plan import logical as JL

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.host import (
    HostBatch, HostColumn, device_to_host, host_to_device)
from spark_rapids_tpu_torch.columnar.wire import WireCorruptionError
from spark_rapids_tpu_torch.memory.stores import (
    batch_to_shard_blob, shard_blob_to_batch)
from spark_rapids_tpu_torch.parallel import transport as T
from spark_rapids_tpu_torch.parallel.exchange import ShuffleExchangeExec
from spark_rapids_tpu_torch.parallel.transport import rendezvous as RV
from spark_rapids_tpu_torch.parallel.transport.base import ShardLostError
from spark_rapids_tpu_torch.parallel.transport.hostfile import (
    HostFileTransport, valid_manifest)
from spark_rapids_tpu_torch.parallel.transport.objectstore import (
    HttpObjectStoreBackend, ObjectMissingError, ObjectStoreStub,
    ObjectStoreTransport, ObjectStoreUnavailableError, make_backend)
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan import plan_cache as pc

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


@pytest.fixture(autouse=True)
def _clean():
    state = faults.snapshot()
    faults.configure("")
    faults.reset_counters()
    T.reset_counters()
    yield
    faults.restore(state)
    pc.cache().clear()


@pytest.fixture()
def stub():
    s = ObjectStoreStub()
    yield s
    s.close()


def _batch(keys, vals):
    hb = HostBatch(
        ("k", "v"),
        [HostColumn(dt.INT64, np.asarray(keys, np.int64),
                    np.ones(len(keys), bool)),
         HostColumn(dt.INT64, np.asarray(vals, np.int64),
                    np.ones(len(vals), bool))])
    return host_to_device(hb, device="cpu")


def _rows(batch):
    return device_to_host(batch).to_pylist()


def _hostfile_conf(tmp_path, **over):
    raw = {C.SHUFFLE_TRANSPORT_HOSTFILE_DIR.key: str(tmp_path)}
    raw.update({getattr(C, k).key: v for k, v in over.items()})
    return C.TpuConf(raw)


def _hf(conf, tag, n, owner=None):
    return HostFileTransport().open(conf, tag, n, owner=owner,
                                    device="cpu")


def _os_conf(stub, prefix="t", **over):
    raw = {C.SHUFFLE_TRANSPORT_OBJECTSTORE_ENDPOINT.key: stub.endpoint,
           C.SHUFFLE_TRANSPORT_OBJECTSTORE_PREFIX.key: prefix,
           C.SHUFFLE_TRANSPORT_OBJECTSTORE_BACKOFF_MS.key: 5}
    raw.update({getattr(C, k).key: v for k, v in over.items()})
    return C.TpuConf(raw)


def _os(conf, tag, n, owner=None):
    return ObjectStoreTransport().open(conf, tag, n, owner=owner,
                                       device="cpu")


# ---------------------------------------------------------------------------
# Selection
# ---------------------------------------------------------------------------

def test_transport_selection_conf_env_legacy(monkeypatch):
    monkeypatch.delenv("SRT_SHUFFLE_TRANSPORT", raising=False)
    assert T.transport_name(C.TpuConf()) == "inprocess"
    assert T.transport_name(C.TpuConf(
        {C.SHUFFLE_TRANSPORT.key: "hostfile"})) == "hostfile"
    assert T.transport_name(C.TpuConf(
        {C.MESH_ENABLED.key: True})) == "mesh"
    monkeypatch.setenv("SRT_SHUFFLE_TRANSPORT", "hostfile")
    assert T.transport_name(C.TpuConf()) == "hostfile"
    assert T.transport_name(C.TpuConf(
        {C.SHUFFLE_TRANSPORT.key: "inprocess"})) == "inprocess"
    with pytest.raises(T.TransportError):
        T.transport_name(C.TpuConf({C.SHUFFLE_TRANSPORT.key: "ucx"}))


def test_mesh_is_registered_and_raises_not_ported():
    """The mesh transport is ported (the name is older): ``mesh`` makes
    the collective path's durable half, and the exchanges the collective
    does not take materialize ``inprocess``, as in the reference."""
    from spark_rapids_tpu_torch.parallel.transport.mesh import \
        MeshTransport
    conf = C.TpuConf({C.SHUFFLE_TRANSPORT.key: "mesh"})
    assert T.transport_name(conf) == "mesh"
    assert isinstance(T.get_transport("mesh"), MeshTransport)
    assert T.materialization_transport(conf).name == "inprocess"
    with pytest.raises(ValueError, match="catalog"):
        T.get_transport("mesh").open(conf, "t", 2)


@pytest.mark.parametrize("how", ["transport", "legacy"])
def test_mesh_query_raises_instead_of_running_inprocess(how):
    """A mesh query runs its hash repartition as the collective
    ``MeshExchangeExec`` (the name is older: the transport used to
    raise); its round robin repartition materializes in process."""
    from spark_rapids_tpu_torch.parallel.mesh_exchange import \
        MeshExchangeExec
    key = {"transport": (C.SHUFFLE_TRANSPORT.key, "mesh"),
           "legacy": (C.MESH_ENABLED.key, True)}[how]
    s = TpuSession({key[0]: key[1],
                    "spark.rapids.sql.shuffle.partitions": 2}, device="cpu")
    base = s.create_dataframe({"a": [1, 2, 3]}, [("a", dt.INT64)])
    hashed = base.repartition(2, "a")
    assert isinstance(hashed._physical().root, MeshExchangeExec)
    assert sorted(hashed.collect()) == [(1,), (2,), (3,)]
    rr = base.repartition(2)
    assert isinstance(rr._physical().root, ShuffleExchangeExec)
    assert sorted(rr.collect()) == [(1,), (2,), (3,)]


def test_register_third_party_transport():
    class Fake(T.ShuffleTransport):
        name = "fake"
    T.register_transport("fake", Fake)
    try:
        assert isinstance(T.get_transport("fake"), Fake)
        assert T.transport_name(C.TpuConf(
            {C.SHUFFLE_TRANSPORT.key: "fake"})) == "fake"
    finally:
        T._REGISTRY.pop("fake", None)
        T._INSTANCES.pop("fake", None)


def test_transport_keys_are_the_references():
    """Every transport key of the reference is registered (defaults:
    tests/test_torch_cost.py's registry-wide parity test)."""
    def keys(mod):
        ks = {getattr(v, "key", None) for v in vars(mod).values()}
        return {k for k in ks if isinstance(k, str) and (
            k.startswith("spark.rapids.sql.shuffle.transport")
            or k == "spark.rapids.sql.mesh.enabled")}
    assert keys(C) == keys(JC)
    assert len(keys(C)) == 20


# ---------------------------------------------------------------------------
# The shard wire format
# ---------------------------------------------------------------------------

_MIXED = ([("i", dt.INT64), ("s", dt.STRING), ("f", dt.FLOAT64),
           ("d", dt.DATE), ("b", dt.BOOL)],
          {"i": [1, None, -7, 2 ** 40], "s": ["x", "yy", None, ""],
           "f": [1.5, None, -0.0, float("nan")], "d": [0, 19000, None, -1],
           "b": [True, False, None, True]})


def _jschema(schema):
    return [(n, jdt.type_named(t.name)) for n, t in schema]


def test_shard_blob_roundtrip_bit_exact():
    b = _batch([1, 2, 3, -7], [10, 20, 30, 40])
    out = shard_blob_to_batch(batch_to_shard_blob(b), "cpu")
    assert _rows(out) == _rows(b)
    assert out.capacity == b.capacity


def test_shard_blob_detects_corruption():
    blob = bytearray(batch_to_shard_blob(_batch([1], [2])))
    blob[len(blob) // 2] ^= 0xFF
    with pytest.raises(WireCorruptionError):
        shard_blob_to_batch(bytes(blob), "cpu")


def test_shard_blob_header_names_no_device():
    """The header is the reference's: no writer device, so the reading
    session's device is the only one the decode can use."""
    import struct
    from spark_rapids_tpu_torch.columnar.wire import unframe_blob
    payload = unframe_blob(batch_to_shard_blob(_batch([1], [2])))
    (hlen,) = struct.unpack_from("<I", payload)
    header = json.loads(payload[4:4 + hlen].decode())
    assert "device" not in header["meta"]
    assert shard_blob_to_batch(batch_to_shard_blob(
        _batch([1], [2])), "cpu").device.type == "cpu"


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_shard_blob_decodes_in_the_other_package(writer):
    schema, data = _MIXED
    want = HostBatch.from_pydict(schema, data).to_pylist()
    if writer == "port":
        blob = batch_to_shard_blob(host_to_device(
            HostBatch.from_pydict(schema, data), device="cpu"))
        got = jd2h(jstores.shard_blob_to_batch(blob)).to_pylist()
    else:
        blob = jstores.batch_to_shard_blob(jh2d(JHostBatch.from_pydict(
            _jschema(schema), data)))
        got = _rows(shard_blob_to_batch(blob, "cpu"))
    assert repr(got) == repr(want)


# ---------------------------------------------------------------------------
# Hostfile (one process)
# ---------------------------------------------------------------------------

def test_hostfile_write_commit_fetch_roundtrip(tmp_path):
    conf = _hostfile_conf(tmp_path)
    w = _hf(conf, "xround", 2, owner=123)
    w.write_shard(0, _batch([1, 2], [3, 4]))
    w.write_shard(1, _batch([5], [6]))
    w.write_shard(0, _batch([7], [8]))
    w.commit()
    r = _hf(conf, "xround", 2)
    got0 = [row for h in r.fetch_shards(0) for row in _rows(h.get())]
    got1 = [row for h in r.fetch_shards(1) for row in _rows(h.get())]
    assert got0 == [(1, 3), (2, 4), (7, 8)]    # (worker, seq) order
    assert got1 == [(5, 6)]
    assert r.fetch_shards(1)[0].capacity >= 1  # manifest-known, no I/O
    assert w.observed_bytes() == sum(
        os.path.getsize(os.path.join(w._my_dir, f))
        for f in os.listdir(w._my_dir))
    r.close()
    w.close()
    assert not os.path.exists(w.root)          # last worker cleaned up
    assert T.counters()["transportShardsWritten"] == 3


def test_hostfile_fetch_waits_for_commit(tmp_path):
    conf = _hostfile_conf(
        tmp_path, SHUFFLE_TRANSPORT_HOSTFILE_FETCH_TIMEOUT_MS=200)
    w = _hf(conf, "xuncommitted", 1, owner=9)
    w.write_shard(0, _batch([1], [2]))
    r = _hf(conf, "xuncommitted", 1, owner=9)
    with pytest.raises(ShardLostError) as ei:
        r.fetch_shards(0)
    assert ei.value.fault_owner == 9
    w.invalidate()


def test_hostfile_lost_shard_raises_owner_tagged(tmp_path):
    conf = _hostfile_conf(tmp_path)
    w = _hf(conf, "xlost", 1, owner=42)
    w.write_shard(0, _batch([1], [2]))
    w.commit()
    for root, _, files in os.walk(w.root):
        for f in files:
            if f.endswith(".shard"):
                os.remove(os.path.join(root, f))
    r = _hf(conf, "xlost", 1, owner=42)
    with pytest.raises(ShardLostError) as ei:
        r.fetch_shards(0)[0].get()
    assert ei.value.fault_owner == 42
    assert "UNAVAILABLE" in str(ei.value)
    w.invalidate()


@pytest.mark.parametrize("flips,refetches", [(1, 1), (2, 2)])
def test_hostfile_corrupt_at_rest_refetches_once(tmp_path, flips,
                                                 refetches):
    """One flipped read recovers on the refetch; two raise the CRC error
    tagged with the owner (the stage recompute's target)."""
    conf = _hostfile_conf(tmp_path)
    w = _hf(conf, "xcorrupt", 1, owner=7)
    w.write_shard(0, _batch([1, 2, 3], [4, 5, 6]))
    w.commit()
    faults.configure(f"corrupt@transport:{flips}", seed=3)
    try:
        r = _hf(conf, "xcorrupt", 1, owner=7)
        if flips == 1:
            assert _rows(r.fetch_shards(0)[0].get()) == \
                [(1, 4), (2, 5), (3, 6)]
        else:
            with pytest.raises(WireCorruptionError) as ei:
                r.fetch_shards(0)[0].get()
            assert ei.value.fault_owner == 7
        assert T.counters().get("remoteShardRefetches") == refetches
    finally:
        faults.configure("")
        w.invalidate()


def test_valid_manifest_schema():
    good = {"worker": "w0", "num_partitions": 2,
            "shards": {"0": [{"file": "w0/p00000-0000.shard",
                              "capacity": 4, "rows": 3}]}}
    assert valid_manifest(good)
    assert not valid_manifest(None)
    assert not valid_manifest([])
    assert not valid_manifest({})
    assert not valid_manifest({**good, "worker": 7})
    assert not valid_manifest({**good, "num_partitions": "2"})
    assert not valid_manifest({**good, "shards": "torn"})
    assert not valid_manifest({**good, "shards": {"0": "torn"}})
    assert not valid_manifest({**good, "shards": {"0": [{"file": 3}]}})
    assert not valid_manifest({**good, "shards": {"0": [{"file": "x"}]}})


def test_hostfile_torn_manifest_reads_as_unpublished(tmp_path):
    conf = _hostfile_conf(
        tmp_path, SHUFFLE_TRANSPORT_HOSTFILE_FETCH_TIMEOUT_MS=150)
    w = _hf(conf, "xtorn", 1, owner=5)
    w.write_shard(0, _batch([1, 2], [3, 4]))
    w.commit()
    mpath = w._manifest_path()
    with open(mpath, encoding="utf-8") as f:
        full = f.read()
    for torn in (full[: len(full) // 2],
                 json.dumps({"worker": "w0", "shards": "torn"})):
        with open(mpath, "w", encoding="utf-8") as f:
            f.write(torn)
        with pytest.raises(ShardLostError) as ei:
            _hf(conf, "xtorn", 1, owner=5).fetch_shards(0)
        assert ei.value.fault_owner == 5
    with open(mpath, "w", encoding="utf-8") as f:
        f.write(full)
    r = _hf(conf, "xtorn", 1, owner=5)
    assert _rows(r.fetch_shards(0)[0].get()) == [(1, 3), (2, 4)]
    w.invalidate()


def test_hostfile_invalidate_drops_spool(tmp_path):
    conf = _hostfile_conf(tmp_path)
    w = _hf(conf, "xinval", 1, owner=1)
    w.write_shard(0, _batch([1], [2]))
    w.commit()
    assert os.path.isdir(w.root)
    w.invalidate()
    assert not os.path.exists(w.root)
    w.write_shard(0, _batch([9], [10]))        # a recompute rewrites
    w.commit()
    assert _rows(_hf(conf, "xinval", 1).fetch_shards(0)[0].get()) == \
        [(9, 10)]
    w.invalidate()


def test_rendezvous_protocol():
    srv = RV.RendezvousServer()
    try:
        assert RV._roundtrip(srv.addr, "PING\n") == "OK"
        assert not RV.wait_committed(srv.addr, "x", 2, 50)
        RV.announce_commit(srv.addr, "x", "w1")
        RV.announce_commit(srv.addr, "x", "w0")
        RV.announce_commit(srv.addr, "x", "w0")    # idempotent
        assert RV._roundtrip(srv.addr, "LIST x\n") == "OK w0,w1"
        assert RV.wait_committed(srv.addr, "x", 2, 1000)
        assert RV._roundtrip(srv.addr, "BOGUS\n") == "ERR"
        assert RV.parse_addr("") is None
        assert RV.parse_addr(":7") == ("127.0.0.1", 7)
    finally:
        srv.close()


def test_rendezvous_dead_peer_degrades_to_polling(tmp_path):
    """A dead rendezvous fails fast, typed UNAVAILABLE; the hostfile
    session then polls the spool, where the manifest is the truth."""
    srv = RV.RendezvousServer()
    addr = f"{srv.addr[0]}:{srv.addr[1]}"
    srv.close()
    with pytest.raises(RV.RendezvousUnavailableError, match="UNAVAILABLE"):
        RV._roundtrip(RV.parse_addr(addr), "PING\n", timeout_s=0.2,
                      retries=1, backoff_ms=1)
    conf = _hostfile_conf(
        tmp_path, SHUFFLE_TRANSPORT_HOSTFILE_RENDEZVOUS=addr,
        SHUFFLE_TRANSPORT_HOSTFILE_RV_CONNECT_TIMEOUT_MS=200,
        SHUFFLE_TRANSPORT_HOSTFILE_RV_RETRIES=0)
    w = _hf(conf, "xrv", 1, owner=2)
    w.write_shard(0, _batch([4], [5]))
    w.commit()
    assert _rows(_hf(conf, "xrv", 1).fetch_shards(0)[0].get()) == [(4, 5)]
    assert T.counters()["rendezvousDegraded"] == 2
    w.invalidate()


def test_hostfile_cross_process_two_workers(tmp_path):
    """Two separate processes of the port map-write shards into the
    shared spool (announcing over the socket rendezvous); this process
    fetches their union through the same SPI."""
    sys.path.insert(0, FIXTURES)
    try:
        from torch_hostfile_worker import worker_rows
    finally:
        sys.path.pop(0)
    script = os.path.join(FIXTURES, "torch_hostfile_worker.py")
    n_parts = 3
    srv = RV.RendezvousServer()
    rv = f"{srv.addr[0]}:{srv.addr[1]}"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = []
    try:
        procs = [subprocess.Popen(
            [sys.executable, script, str(tmp_path), "xproc", w,
             str(n_parts), rv],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for w in ("w0", "w1")]
        conf = _hostfile_conf(
            tmp_path, SHUFFLE_TRANSPORT_HOSTFILE_EXPECTED_WORKERS=2,
            SHUFFLE_TRANSPORT_HOSTFILE_RENDEZVOUS=rv,
            SHUFFLE_TRANSPORT_HOSTFILE_FETCH_TIMEOUT_MS=60000)
        r = _hf(conf, "xproc", n_parts)
        for p in range(n_parts):
            got = [row for h in r.fetch_shards(p) for row in _rows(h.get())]
            want = []
            for w in ("w0", "w1"):     # manifest (worker) order
                keys, vals = worker_rows(w, p)
                want += list(zip(keys, vals))
            assert got == want, f"partition {p}"
        for pr in procs:
            out, _ = pr.communicate(timeout=60)
            assert pr.returncode == 0, out.decode()
        r.close()
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait(10)
        srv.close()


# ---------------------------------------------------------------------------
# Objectstore against the stub
# ---------------------------------------------------------------------------

def test_stub_backend_put_get_list_delete(stub):
    b = make_backend(stub.endpoint, timeout_s=2.0)
    assert isinstance(b, HttpObjectStoreBackend)
    b.put("a/x", b"one")
    b.put("a/y", b"two")
    b.put("b/z", b"three")
    assert b.get("a/y") == b"two"
    assert b.list_keys("a/") == ["a/x", "a/y"]
    b.delete("a/x")
    b.delete("a/x")                            # idempotent
    assert b.list_keys("a/") == ["a/y"]
    with pytest.raises(ObjectMissingError):
        b.get("a/x")


def test_stub_5xx_surfaces_typed_unavailable(stub):
    b = make_backend(stub.endpoint, timeout_s=2.0)
    b.put("k", b"v")
    stub.fail_next(1)
    with pytest.raises(ObjectStoreUnavailableError, match="UNAVAILABLE"):
        b.get("k")
    assert b.get("k") == b"v"


def test_stub_http_admin_surface_steers_chaos(stub):
    b = make_backend(stub.endpoint, timeout_s=2.0)
    b.put("c/s1", b"x")
    b.put("c/s2", b"y")

    def admin(path):
        req = urllib.request.Request(f"{stub.endpoint}{path}",
                                     method="POST")
        with urllib.request.urlopen(req, timeout=2.0) as r:
            return r.read()

    assert json.loads(admin("/admin/drop?prefix=c/s1")) == ["c/s1"]
    admin("/admin/fail?n=1&code=503")
    with pytest.raises(ObjectStoreUnavailableError):
        b.get("c/s2")
    with urllib.request.urlopen(f"{stub.endpoint}/admin/stats",
                                timeout=2.0) as r:
        assert json.loads(r.read())["failed"] >= 1


def test_objectstore_write_commit_fetch_roundtrip(stub):
    conf = _os_conf(stub)
    w = _os(conf, "xround", 2, owner=123)
    w.write_shard(0, _batch([1, 2], [3, 4]))
    w.write_shard(1, _batch([5], [6]))
    w.write_shard(0, _batch([7], [8]))
    w.commit()
    r = _os(conf, "xround", 2)
    got0 = [row for h in r.fetch_shards(0) for row in _rows(h.get())]
    got1 = [row for h in r.fetch_shards(1) for row in _rows(h.get())]
    assert got0 == [(1, 3), (2, 4), (7, 8)]
    assert got1 == [(5, 6)]
    r.close()
    w.close()
    assert stub.keys("t/xround") == []


def test_objectstore_fetch_waits_for_manifest(stub):
    conf = _os_conf(stub, SHUFFLE_TRANSPORT_OBJECTSTORE_FETCH_TIMEOUT_MS=200)
    w = _os(conf, "xbarrier", 1, owner=9)
    w.write_shard(0, _batch([1], [2]))
    with pytest.raises(ShardLostError) as ei:
        _os(conf, "xbarrier", 1, owner=9).fetch_shards(0)
    assert ei.value.fault_owner == 9
    w.invalidate()


def test_objectstore_torn_manifest_reads_as_unpublished(stub):
    conf = _os_conf(stub, SHUFFLE_TRANSPORT_OBJECTSTORE_FETCH_TIMEOUT_MS=150)
    b = make_backend(stub.endpoint, timeout_s=2.0)
    w = _os(conf, "xtorn", 1, owner=4)
    w.write_shard(0, _batch([1], [2]))
    w.commit()
    mkey = w._manifest_key()
    full = b.get(mkey)
    for torn in (full[: len(full) // 2],
                 json.dumps({"worker": "w", "shards": "torn"}).encode()):
        b.put(mkey, torn)
        with pytest.raises(ShardLostError) as ei:
            _os(conf, "xtorn", 1, owner=4).fetch_shards(0)
        assert ei.value.fault_owner == 4
    b.put(mkey, full)
    assert _rows(_os(conf, "xtorn", 1, owner=4).fetch_shards(0)[0].get()) \
        == [(1, 2)]
    w.invalidate()


@pytest.mark.parametrize("burst", [1, 3])
def test_5xx_burst_absorbed_by_bounded_retry(stub, burst):
    conf = _os_conf(stub, SHUFFLE_TRANSPORT_OBJECTSTORE_RETRIES=4)
    w = _os(conf, "xburst", 1, owner=1)
    w.write_shard(0, _batch([1], [2]))
    w.commit()
    stub.fail_next(burst)
    r = _os(conf, "xburst", 1, owner=1)
    assert _rows(r.fetch_shards(0)[0].get()) == [(1, 2)]
    assert T.counters().get("objectstoreRetries", 0) == burst
    w.invalidate()


def test_retry_exhaustion_surfaces_typed_unavailable(stub):
    conf = _os_conf(stub, SHUFFLE_TRANSPORT_OBJECTSTORE_RETRIES=1)
    w = _os(conf, "xdown", 1, owner=1)
    stub.fail_next(10)
    with pytest.raises(ObjectStoreUnavailableError):
        w.write_shard(0, _batch([1], [2]))
    assert T.counters().get("objectstoreRetries") == 1


def test_shard_loss_at_rest_raises_owner_tagged(stub):
    conf = _os_conf(stub)
    w = _os(conf, "xloss", 1, owner=42)
    w.write_shard(0, _batch([1], [2]))
    w.commit()
    handles = _os(conf, "xloss", 1, owner=42).fetch_shards(0)
    stub.drop("t/xloss/")
    with pytest.raises(ShardLostError) as ei:
        handles[0].get()
    assert ei.value.fault_owner == 42
    assert T.counters().get("remoteShardsLost", 0) == 1


def test_objectstore_corrupt_at_rest_refetches_once(stub):
    conf = _os_conf(stub)
    w = _os(conf, "xcorrupt", 1, owner=7)
    w.write_shard(0, _batch([1, 2, 3], [4, 5, 6]))
    w.commit()
    faults.configure("corrupt@transport:1", seed=3)
    try:
        r = _os(conf, "xcorrupt", 1, owner=7)
        assert _rows(r.fetch_shards(0)[0].get()) == \
            [(1, 4), (2, 5), (3, 6)]
        assert T.counters().get("remoteShardRefetches") == 1
    finally:
        faults.configure("")
        w.invalidate()


def test_fault_unavailable_objectstore_absorbed_by_retry(stub):
    conf = _os_conf(stub, SHUFFLE_TRANSPORT_OBJECTSTORE_RETRIES=3)
    faults.configure("unavailable@objectstore:1", seed=5)
    try:
        w = _os(conf, "xfault", 1, owner=1)
        w.write_shard(0, _batch([1], [2]))
        w.commit()
        assert _rows(_os(conf, "xfault", 1).fetch_shards(0)[0].get()) == \
            [(1, 2)]
        assert T.counters().get("objectstoreRetries", 0) >= 1
    finally:
        faults.configure("")
        w.invalidate()


def test_fault_slowput_transport_is_latency_not_error(stub):
    conf = _os_conf(stub)
    faults.configure("slowput@transport:1", seed=5)
    try:
        w = _os(conf, "xslow", 1, owner=1)
        t0 = time.monotonic()
        w.write_shard(0, _batch([1], [2]))
        assert time.monotonic() - t0 >= 0.2
        w.commit()
        assert _rows(_os(conf, "xslow", 1).fetch_shards(0)[0].get()) == \
            [(1, 2)]
        assert T.counters().get("slowPuts", 0) == 1
    finally:
        faults.configure("")
        w.invalidate()


@pytest.mark.parametrize("kind", ["hostfile", "objectstore"])
def test_injected_lostshard_deletes_at_rest_first(stub, tmp_path, kind):
    if kind == "hostfile":
        conf, open_ = _hostfile_conf(tmp_path), _hf
    else:
        conf, open_ = _os_conf(stub), _os
    w = open_(conf, "xdel", 1, owner=3)
    w.write_shard(0, _batch([1], [2]))
    w.commit()
    faults.configure("lostshard@transport:1", seed=2)
    try:
        with pytest.raises(ShardLostError) as ei:
            open_(conf, "xdel", 1, owner=3).fetch_shards(0)[0].get()
        assert ei.value.fault_owner == 3
        if kind == "hostfile":
            left = [f for _, _, fs in os.walk(w.root) for f in fs
                    if f.endswith(".shard")]
        else:
            left = [k for k in stub.keys("t/xdel") if k.endswith(".shard")]
        assert left == []                      # a recovery must rewrite
        assert T.counters().get("remoteShardsLost") == 1
    finally:
        faults.configure("")
        w.invalidate()


# ---------------------------------------------------------------------------
# End to end through the exchange
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def parity_dir(tmp_path_factory):
    import pandas as pd
    d = tmp_path_factory.mktemp("torch_transport_parity")
    rng = np.random.default_rng(11)
    pd.DataFrame({"k": rng.integers(0, 40, 4000),
                  "v": rng.integers(0, 10 ** 6, 4000)}) \
        .to_parquet(str(d / "t.parquet"))
    pd.DataFrame({"k2": np.arange(40), "w": rng.integers(0, 10 ** 6, 40)}) \
        .to_parquet(str(d / "d.parquet"))
    return str(d)


def _parity_query(session, data_dir, M):
    a = session.read.parquet(os.path.join(data_dir, "t.parquet"))
    b = session.read.parquet(os.path.join(data_dir, "d.parquet"))
    j = a.join_on(b, ["k"], ["k2"], strategy="shuffle")
    return j.group_by("k").agg(
        M.agg_sum(M.col("v") + M.col("w")).alias("s")) \
        .order_by(M.col("k").asc())


PARTS = {"spark.rapids.sql.shuffle.partitions": 4}


@pytest.fixture(scope="module")
def reference_rows(parity_dir):
    """The reference's rows of the parity query at 4 partitions (its
    host engine: integer sums, so every engine agrees to the bit)."""
    return _parity_query(JSession(dict(PARTS)), parity_dir, JL) \
        .collect_host()


def _port_session(name, tmp_path, stub=None, **extra):
    conf = dict(PARTS, **{
        C.SHUFFLE_TRANSPORT.key: name,
        C.SHUFFLE_TRANSPORT_HOSTFILE_DIR.key: str(tmp_path / "spool")})
    if stub is not None:
        conf[C.SHUFFLE_TRANSPORT_OBJECTSTORE_ENDPOINT.key] = stub.endpoint
    conf.update(extra)
    return TpuSession(conf, device="cpu")


def _spool_files(tmp_path):
    root = tmp_path / "spool"
    return [f for _, _, fs in os.walk(root) for f in fs] \
        if root.exists() else []


@pytest.mark.parametrize("name", ["inprocess", "hostfile", "objectstore",
                                  "mesh"])
def test_join_agg_rows_match_reference_across_transports(
        name, parity_dir, reference_rows, stub, tmp_path):
    df = _parity_query(_port_session(name, tmp_path, stub), parity_dir, L)
    assert df.collect() == reference_rows
    m = df.metrics()
    if name == "mesh":
        from spark_rapids_tpu_torch.parallel.mesh_exchange import \
            MeshExchangeExec
        # The hash shuffles run as collectives; their shards are catalog
        # handles, counted as inprocess's are not, and nothing spools.
        assert any(k.startswith(MeshExchangeExec.__name__) for k in m)
        assert m.get("Transport@query", {}) == {}
        assert not faults.counters().get("meshDegrades")
    elif name == "inprocess":
        assert m.get("Transport@query", {}) == {}
    else:
        t = m["Transport@query"]
        assert t["transportShardsWritten"] >= 4
        assert t["transportShardsFetched"] == t["transportShardsWritten"]
    assert df._physical().last_ctx.last_leak_report == []
    assert _spool_files(tmp_path) == [] and stub.keys() == []


@pytest.mark.parametrize("name", ["hostfile", "objectstore"])
def test_lost_shard_recomputes_its_owner_stage(name, parity_dir,
                                               reference_rows, stub,
                                               tmp_path):
    df = _parity_query(_port_session(
        name, tmp_path, stub,
        **{"spark.rapids.sql.test.faults": "lostshard@transport:1",
           "spark.rapids.sql.retry.backoffMs": 1}), parity_dir, L)
    assert df.collect() == reference_rows
    rec = df.metrics()["Recovery@query"]
    assert rec["stageRecomputes"] == 1
    assert rec.get("retriesAttempted", 0) == 0
    assert T.counters()["remoteShardsLost"] == 1
    assert _spool_files(tmp_path) == [] and stub.keys() == []


def test_spool_file_deleted_mid_query_recomputes(parity_dir, reference_rows,
                                                 tmp_path, monkeypatch):
    """A shard file vanishes between the map side's commit and the first
    fetch (a reaped spool): the fetch raises owner-tagged, the owner
    stage recomputes and rewrites it, and the rows are the same."""
    deleted = []
    orig = ShuffleExchangeExec._materialize_device_traced

    def materialize_then_lose(self, ctx, key):
        sess = orig(self, ctx, key)
        if not deleted:
            for root, _, fs in os.walk(sess.root):
                for f in fs:
                    if f.endswith(".shard"):
                        os.remove(os.path.join(root, f))
                        deleted.append(f)
                        break
                if deleted:
                    break
        return sess

    monkeypatch.setattr(ShuffleExchangeExec, "_materialize_device_traced",
                        materialize_then_lose)
    df = _parity_query(_port_session("hostfile", tmp_path), parity_dir, L)
    assert df.collect() == reference_rows
    assert len(deleted) == 1
    assert df.metrics()["Recovery@query"]["stageRecomputes"] == 1
    assert _spool_files(tmp_path) == []


def test_corrupt_shard_in_query_is_refetched(parity_dir, reference_rows,
                                             tmp_path):
    df = _parity_query(_port_session(
        "hostfile", tmp_path,
        **{"spark.rapids.sql.test.faults": "corrupt@transport:1",
           "spark.rapids.sql.test.faults.seed": 3}), parity_dir, L)
    assert df.collect() == reference_rows
    assert T.counters()["remoteShardRefetches"] == 1
    assert df.metrics()["Recovery@query"].get("stageRecomputes", 0) == 0
