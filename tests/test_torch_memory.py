"""Port parity of the memory tier (``memory/stores.py``, ``memory/oom.py``,
``memory/compression.py``, ``memory/native.py`` and the wire CRC frame)
against the JAX package's, on the same seeded inputs.

- Spill serialization: a batch of every dtype (strings and NULLs, a dead
  tail, a selection vector) spills to the host tier and, through each
  codec, to disk, and restores bit for bit (data, validity, string
  lengths and byte matrices, ``sel``, ``num_rows``, ``rows_hint``); the
  host buffers and the disk blob equal the JAX package's byte for byte,
  and a spilled entry holds no torch tensor.
- The catalog: the device -> host -> disk cascade and its restores, lower
  priorities spilling first, an acquired entry never spilling, the
  ``spill_some`` / ``handle_oom`` rungs, ``leak_report`` after ``close``,
  and ``ExecContext.close``.
- LZ4: round trips, real shrinkage, the same compressed bytes as the JAX
  package's codec, a truncated blob rejected, and a corrupt disk frame
  rejected with ``WireCorruptionError`` after one re-read.
- ``retry_on_oom``: one retry after a spill on ``torch.OutOfMemoryError``
  (the same ladder as the JAX package's for the same failure), a non-OOM
  error passed through, the original error re-raised when no rung can
  act, ``OomRetryExhausted`` after the shrink rung, and a raw
  "out of memory" status recognised by its message.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar import host as jhost
from spark_rapids_tpu.memory import compression as jcomp
from spark_rapids_tpu.memory import oom as joom
from spark_rapids_tpu.memory import stores as jstores

from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar import host as thost
from spark_rapids_tpu_torch.columnar import wire as twire
from spark_rapids_tpu_torch.memory import compression as tcomp
from spark_rapids_tpu_torch.memory import native as tnative
from spark_rapids_tpu_torch.memory import oom as toom
from spark_rapids_tpu_torch.memory import stores as tstores
from spark_rapids_tpu_torch.memory.stores import (
    PRIORITY_ACTIVE_INPUT, PRIORITY_DEFAULT, PRIORITY_SHUFFLE_OUTPUT,
    BufferCatalog, SpillableBatch, StorageTier)
from spark_rapids_tpu_torch.ops.base import ExecContext, Metrics

TYPES = ("bool", "int8", "int16", "int32", "int64", "float32", "float64",
         "date", "timestamp", "string")


@pytest.fixture(autouse=True)
def _clean_ladder():
    toom.reset_degradation()
    joom.reset_degradation()
    toom.set_active_catalog(None)
    yield
    toom.reset_degradation()
    joom.reset_degradation()
    toom.set_active_catalog(None)
    joom.set_active_catalog(None)


def _values(seed: int, n: int = 48):
    """{type name: python values with NULLs} over ``n`` rows."""
    rng = np.random.default_rng(seed)
    null = rng.random(n) < 0.2
    out = {}
    for t in TYPES:
        if t == "bool":
            v = rng.integers(0, 2, n).astype(bool).tolist()
        elif t in ("float32", "float64"):
            v = rng.normal(size=n)
            v[:4] = [np.nan, -0.0, np.inf, 1e-310 if t == "float64" else 0.5]
            v = v.astype(np.float32 if t == "float32" else np.float64)
            v = v.tolist()
        elif t == "string":
            v = ["".join(chr(97 + int(c)) for c in
                         rng.integers(0, 26, int(rng.integers(0, 12))))
                 for _ in range(n)]
        else:
            info = np.iinfo(np.dtype(t if t not in ("date", "timestamp")
                                     else ("int32" if t == "date"
                                           else "int64")))
            v = rng.integers(max(info.min, -(1 << 40)),
                             min(info.max, 1 << 40), n).tolist()
        out[t] = [None if z else x for x, z in zip(v, null.tolist())]
    return out


def _pair(seed: int, n: int = 48):
    """The same host batch uploaded by both packages (capacity 64, so the
    tail is dead padding)."""
    vals = _values(seed, n)
    tschema = [(f"c_{t}", tdt.type_named(t)) for t in TYPES]
    jschema = [(f"c_{t}", jdt.type_named(t)) for t in TYPES]
    data = {f"c_{t}": vals[t] for t in TYPES}
    tb = thost.host_to_device(thost.HostBatch.from_pydict(tschema, data),
                              capacity=64, device="cpu")
    jb = jhost.host_to_device(jhost.HostBatch.from_pydict(jschema, data),
                              capacity=64)
    return tb, jb


def _tensors(b):
    out = [b.num_rows]
    for c in b.columns:
        out += [c.data, c.validity] + ([c.lengths] if c.lengths is not None
                                       else [])
    if b.sel is not None:
        out.append(b.sel)
    return out


def _assert_same_batch(a, b):
    assert a.rows_hint == b.rows_hint
    assert (a.sel is None) == (b.sel is None)
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and x.shape == y.shape
        # Bit for bit, NaN payloads and -0.0 included.
        assert x.numpy().tobytes() == y.numpy().tobytes()


def _holds_tensor(entry) -> bool:
    def walk(o):
        if isinstance(o, torch.Tensor):
            return True
        if isinstance(o, (list, tuple)):
            return any(walk(x) for x in o)
        if isinstance(o, dict):
            return any(walk(x) for x in o.values())
        return False
    return any(walk(getattr(entry, f)) for f in (
        "device_batch", "host_meta", "host_bufs", "disk_meta",
        "disk_directory"))


# ---------------------------------------------------------------------------
# Spill serialization
# ---------------------------------------------------------------------------

def test_host_buffers_match_reference():
    """The host tier's image of a batch is the JAX package's, buffer for
    buffer, and its disk blob the same bytes."""
    tb, jb = _pair(1)
    tmeta, tbufs = tstores._batch_to_numpy(tb)
    jmeta, jbufs = jstores._batch_to_numpy(jb)
    assert len(tbufs) == len(jbufs)
    for x, y in zip(tbufs, jbufs):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()
    assert tmeta["num_rows"] == jmeta["num_rows"] == 48
    assert [c["dtype"] for c in tmeta["cols"]] == \
        [c["dtype"] for c in jmeta["cols"]]
    tblob, tdir = tstores._serialize_bufs(tbufs)
    jblob, jdir = jstores._serialize_bufs(jbufs)
    assert tblob == jblob
    assert [(d["dtype"], tuple(d["shape"])) for d in tdir] == \
        [(d["dtype"], tuple(d["shape"])) for d in jdir]


@pytest.mark.parametrize("codec", ["lz4", "copy", "none"])
@pytest.mark.parametrize("with_sel", [False, True])
def test_round_trip_every_tier(tmp_path, codec, with_sel):
    """Device -> host -> disk and back, bit for bit, and a spilled entry
    holds no tensor."""
    tb, _ = _pair(2)
    if with_sel:
        tb = tb.with_sel(torch.arange(64) % 3 != 1)
    tb.rows_hint = None if with_sel else 48
    want = tstores._numpy_to_batch(*tstores._batch_to_numpy(tb))
    _assert_same_batch(want, tb)
    cat = BufferCatalog(device_budget_bytes=1 << 30, host_budget_bytes=1 << 30,
                        spill_dir=str(tmp_path), compression_codec=codec)
    bid = cat.add_batch(tb)
    assert cat.spill_some() > 0
    assert cat.tier_of(bid) == StorageTier.HOST
    assert not _holds_tensor(cat.entry(bid))
    _assert_same_batch(cat.acquire_batch(bid), tb)
    cat.release(bid)
    cat.host_budget = 0
    assert cat.handle_oom() > 0
    assert cat.tier_of(bid) == StorageTier.DISK
    assert not _holds_tensor(cat.entry(bid))
    assert cat.disk_bytes > 0
    back = cat.acquire_batch(bid)
    _assert_same_batch(back, tb)
    assert cat.metrics["restore_from_host"] == 1
    assert cat.metrics["restore_from_disk"] == 1
    cat.remove(bid)
    assert cat.leak_report() == []
    cat.close()


# ---------------------------------------------------------------------------
# The catalog (tests/test_memory.py's TestCatalogSpill)
# ---------------------------------------------------------------------------

def _batch(seed, n=64):
    rng = np.random.default_rng(seed)
    hb = thost.HostBatch.from_pydict(
        [("a", tdt.INT64), ("s", tdt.STRING)],
        {"a": rng.integers(0, 1000, n).tolist(),
         "s": [f"row{seed}_{i}" for i in range(n)]})
    return thost.host_to_device(hb, device="cpu")


def _rows(b):
    return thost.device_to_host(b).to_pylist()


def test_device_to_host_spill_on_budget(tmp_path):
    size = _batch(1).device_size_bytes()
    cat = BufferCatalog(device_budget_bytes=int(size * 2.5),
                        host_budget_bytes=1 << 30, spill_dir=str(tmp_path))
    ids = [cat.add_batch(_batch(i)) for i in range(3)]
    # The third add pushes the first (lowest id) to the host.
    assert cat.tier_of(ids[0]) == StorageTier.HOST
    assert cat.tier_of(ids[2]) == StorageTier.DEVICE
    assert cat.metrics["spill_to_host"] >= 1
    assert _rows(cat.acquire_batch(ids[0])) == _rows(_batch(0))
    assert cat.tier_of(ids[0]) == StorageTier.DEVICE
    cat.close()


def test_cascade_to_disk_and_restore(tmp_path):
    size = _batch(0).device_size_bytes()
    cat = BufferCatalog(device_budget_bytes=int(size * 1.5),
                        host_budget_bytes=int(size * 1.5),
                        spill_dir=str(tmp_path), compression_codec="lz4")
    ids = [cat.add_batch(_batch(i)) for i in range(4)]
    tiers = [cat.tier_of(i) for i in ids]
    assert tiers == [StorageTier.DISK, StorageTier.DISK, StorageTier.HOST,
                     StorageTier.DEVICE]
    assert cat.metrics["spill_to_disk"] == 2
    assert (cat.device_bytes, cat.host_bytes) == (size, size)
    assert cat.disk_bytes > 0
    for seed in (0, 2):
        assert _rows(cat.acquire_batch(ids[seed])) == _rows(_batch(seed))
        cat.release(ids[seed])
    # Restoring entry 0 makes room by spilling entry 3 to the host, which
    # pushes entry 2 on to disk, where it is then read back from.
    assert cat.metrics["restore_from_disk"] == 2
    assert cat.metrics["restore_from_host"] == 0
    cat.close()


def test_priorities_shuffle_spills_first(tmp_path):
    size = _batch(0).device_size_bytes()
    cat = BufferCatalog(device_budget_bytes=int(size * 2.5),
                        spill_dir=str(tmp_path))
    keep = cat.add_batch(_batch(1), PRIORITY_DEFAULT)
    shuffle = cat.add_batch(_batch(2), PRIORITY_SHUFFLE_OUTPUT)
    cat.add_batch(_batch(3))        # forces one spill
    assert cat.tier_of(shuffle) == StorageTier.HOST
    assert cat.tier_of(keep) == StorageTier.DEVICE
    cat.close()


def test_acquired_entry_never_spills(tmp_path):
    size = _batch(0).device_size_bytes()
    cat = BufferCatalog(device_budget_bytes=int(size * 1.5),
                        spill_dir=str(tmp_path))
    active = cat.add_batch(_batch(1), PRIORITY_ACTIVE_INPUT)
    sb = SpillableBatch(cat, _batch(4), PRIORITY_SHUFFLE_OUTPUT)
    sb.get()                        # acquired: pinned until released
    cat.add_batch(_batch(2))
    cat.add_batch(_batch(3))
    assert cat.tier_of(active) == StorageTier.DEVICE
    assert cat.tier_of(sb.buffer_id) == StorageTier.DEVICE
    assert cat.handle_oom() > 0
    assert cat.tier_of(sb.buffer_id) == StorageTier.DEVICE
    sb.release(PRIORITY_SHUFFLE_OUTPUT)
    assert cat.spill_some() > 0
    assert cat.tier_of(sb.buffer_id) == StorageTier.HOST
    cat.close()


def test_spill_order_matches_reference(tmp_path):
    """The same adds under the same budgets leave every entry on the
    same tier in both packages."""
    tcat = BufferCatalog(device_budget_bytes=10_000, host_budget_bytes=9_000,
                         spill_dir=str(tmp_path))
    jcat = jstores.BufferCatalog(device_budget_bytes=10_000,
                                 host_budget_bytes=9_000,
                                 spill_dir=str(tmp_path / "j"))
    prios = [PRIORITY_DEFAULT, PRIORITY_SHUFFLE_OUTPUT, PRIORITY_DEFAULT,
             PRIORITY_SHUFFLE_OUTPUT, 75, PRIORITY_DEFAULT]
    tids, jids = [], []
    for i, pr in enumerate(prios):
        tb, jb = _pair(10 + i, n=8 + 4 * i)
        assert tb.device_size_bytes() == jb.device_size_bytes()
        tids.append(tcat.add_batch(tb, pr))
        jids.append(jcat.add_batch(jb, pr))
    assert [tcat.tier_of(i) for i in tids] == \
        [jcat.tier_of(i) for i in jids]
    assert len({tcat.tier_of(i) for i in tids}) == 3
    for k in ("spill_to_host", "spill_to_disk"):
        assert tcat.metrics[k] == jcat.metrics[k]
    tcat.close()
    jcat.close()


def test_leak_report_and_context_close(tmp_path):
    cat = BufferCatalog(spill_dir=str(tmp_path))
    handles = [SpillableBatch(cat, _batch(i)) for i in range(3)]
    assert len(cat.leak_report()) == 3
    for h in handles:
        h.close()
        h.close()                   # idempotent
    assert cat.leak_report() == []
    cat.close()
    # The context runs its close hooks (an exchange closes its pieces)
    # before it takes the report; a handle no one closes is reported.
    ctx = ExecContext()
    ctx.conf.set("spark.rapids.memory.spill.dir", str(tmp_path))
    kept = SpillableBatch(ctx.catalog, _batch(5))
    ctx.on_close.append(kept.close)
    leaked = SpillableBatch(ctx.catalog, _batch(6))
    ctx.cache["one"] = leaked
    ctx.close()
    assert [bid for bid, _, _ in ctx.last_leak_report] == [leaked.buffer_id]
    assert ctx.cache == {} and ctx.on_close == []
    assert ctx.last_spill_metrics["spill_to_host"] == 0


# ---------------------------------------------------------------------------
# LZ4, the native spill file and the CRC frame (tests/test_compression.py)
# ---------------------------------------------------------------------------

PAYLOADS = [
    b"",
    b"a",
    b"hello world " * 200,
    np.random.default_rng(3).integers(0, 256, 10_000).astype(
        np.uint8).tobytes(),
    np.arange(50_000, dtype=np.int32).view(np.uint8).tobytes(),
    b"\x00" * 100_000,
]


@pytest.mark.parametrize("name", ["lz4", "copy"])
def test_codec_round_trip(name):
    codec = tcomp.get_codec(name)
    assert codec.name == name
    for p in PAYLOADS:
        assert codec.decompress(codec.compress(p), len(p)) == p


def test_lz4_matches_reference_and_shrinks():
    codec = tcomp.get_codec("lz4")
    assert isinstance(codec, tcomp.Lz4Codec)
    ref = jcomp.get_codec("lz4")
    for p in PAYLOADS:
        assert codec.compress(p) == ref.compress(p)
    p = b"spark rapids tpu " * 4096
    assert len(codec.compress(p)) < len(p) // 4
    good = codec.compress(b"x" * 1000)
    with pytest.raises(OSError):
        codec.decompress(good[: len(good) // 2], 1000)


def test_codec_registry():
    assert tcomp.get_codec("none") is None
    assert tcomp.get_codec("") is None
    assert isinstance(tcomp.get_codec("copy"), tcomp.CopyCodec)
    with pytest.raises(ValueError):
        tcomp.get_codec("zstd-nope")
    with pytest.raises(ValueError):
        BufferCatalog(compression_codec="zstd-nope")


def test_native_spill_file(tmp_path):
    f = tnative.NativeSpillFile(str(tmp_path))
    b1 = f.write(b"hello world")
    b2 = f.write(b"x" * 4096)
    assert f.read(b1) == b"hello world" and f.read(b2) == b"x" * 4096
    assert f.allocated_bytes == 11 + 4096
    f.free(b1)
    assert f.allocated_bytes == 4096
    b3 = f.write(b"abc")           # first fit reuses the freed range
    assert f.read(b3) == b"abc"
    assert f.file_bytes == 11 + 4096
    f.close()
    assert tnative.library_path("spill_store.cpp").exists()


def test_frame_matches_reference_and_rejects_corruption():
    from spark_rapids_tpu.columnar import wire as jwire
    blob = b"payload " * 100
    framed = twire.frame_blob(blob)
    assert framed == jwire.frame_blob(blob)
    assert twire.unframe_blob(framed) == blob
    flipped = bytearray(framed)
    flipped[40] ^= 1
    for bad in (bytes(flipped), framed[:-1], b"XXXX" + framed[4:],
                framed[:8]):
        with pytest.raises(twire.WireCorruptionError):
            twire.unframe_blob(bad)


def test_corrupt_disk_frame_raises(tmp_path, monkeypatch):
    cat = BufferCatalog(device_budget_bytes=1, host_budget_bytes=0,
                        spill_dir=str(tmp_path), compression_codec="lz4")
    bid = cat.add_batch(_batch(7))
    cat.add_batch(_batch(8))
    assert cat.tier_of(bid) == StorageTier.DISK
    real = tnative.NativeSpillFile.read

    def corrupt(self, block_id):
        raw = bytearray(real(self, block_id))
        raw[-1] ^= 0xFF
        return bytes(raw)

    monkeypatch.setattr(tnative.NativeSpillFile, "read", corrupt)
    with pytest.raises(twire.WireCorruptionError):
        cat.acquire_batch(bid)
    assert cat.metrics["corruption_detected"] == 2
    cat.close()


# ---------------------------------------------------------------------------
# retry_on_oom (tests/test_memory.py's TestOomRetry)
# ---------------------------------------------------------------------------

def _cuda_oom():
    return torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")


def test_retry_after_spill(tmp_path):
    cat = BufferCatalog(device_budget_bytes=1 << 30, spill_dir=str(tmp_path))
    bid = cat.add_batch(_batch(1))
    rec = Metrics(owner="Recovery")
    toom.set_active_catalog(cat, rec)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise _cuda_oom()
        return "ok"

    assert toom.retry_on_oom(flaky) == "ok"
    assert len(calls) == 2
    assert toom.last_ladder == ["spill-some"]
    assert cat.tier_of(bid) == StorageTier.HOST
    assert cat.metrics["oom_spills"] == 1
    assert rec.values == {"spillEscalations": 1, "retriesAttempted": 1}
    assert _rows(cat.acquire_batch(bid)) == _rows(_batch(1))
    cat.close()


@pytest.mark.parametrize("fails", [1, 2, 3, 10])
def test_ladder_matches_reference(tmp_path, fails):
    """The same failure count walks the same rungs, with the same calls,
    in both packages (the reference's OOM marker is its XLA status)."""
    results = []
    for pkg, stores, oom, batch in (
            ("torch", tstores, toom, _pair(3)[0]),
            ("jax", jstores, joom, _pair(3)[1])):
        cat = stores.BufferCatalog(device_budget_bytes=1 << 30,
                                   spill_dir=str(tmp_path / pkg))
        cat.add_batch(batch)
        cat.add_batch(batch)
        oom.set_active_catalog(cat)
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) <= fails:
                raise RuntimeError("RESOURCE_EXHAUSTED: Out of memory "
                                   "allocating 12345 bytes")
            return "ok"

        try:
            got = oom.retry_on_oom(flaky)
        except oom.OomRetryExhausted as e:
            got = ("exhausted", tuple(e.rungs))
        results.append((got, len(calls), tuple(oom.last_ladder),
                        oom.degrade_factor()))
        oom.set_active_catalog(None)
        cat.close()
    assert results[0] == results[1]


def test_non_oom_propagates():
    def bad():
        raise ValueError("boom")

    with pytest.raises(ValueError):
        toom.retry_on_oom(bad)


def test_nothing_spillable_reraises_original(tmp_path):
    cat = BufferCatalog(device_budget_bytes=1 << 30, spill_dir=str(tmp_path))
    toom.set_active_catalog(cat)
    while toom.shrink_batch_target():
        pass                        # no rung can act any more
    err = _cuda_oom()

    def oom():
        raise err

    with pytest.raises(torch.OutOfMemoryError) as info:
        toom.retry_on_oom(oom)
    assert info.value is err
    assert toom.last_ladder == []
    cat.close()


def test_exhausted_after_shrink(tmp_path):
    cat = BufferCatalog(device_budget_bytes=1 << 30, spill_dir=str(tmp_path))
    cat.add_batch(_batch(2))
    toom.set_active_catalog(cat)
    calls = []

    def oom():
        calls.append(1)
        raise _cuda_oom()

    with pytest.raises(toom.OomRetryExhausted) as info:
        toom.retry_on_oom(oom)
    assert info.value.rungs == ["spill-some", "shrink"]
    assert not toom.is_oom_error(info.value)
    assert len(calls) == 3
    assert toom.degrade_factor() == 2
    assert toom.effective_batch_target(4 << 20) == 2 << 20
    assert toom.effective_batch_target(100) == 1 << 12
    cat.close()


def test_is_oom_error():
    assert toom.is_oom_error(_cuda_oom())
    assert toom.is_oom_error(RuntimeError(
        "join_probe launch failed: out of memory"))
    assert not toom.is_oom_error(RuntimeError("device-side assert"))
    assert not toom.is_oom_error(
        toom.OomRetryExhausted(_cuda_oom(), ["shrink"]))
