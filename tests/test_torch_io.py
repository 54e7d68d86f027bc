"""Port parity of the file-I/O slice's scan side on the CPU: the port's
``io/arrow_convert.py`` and ``io/scan.py`` against the JAX package's.

- ``arrow_to_host_batch`` / ``host_batch_to_arrow`` for every arrow type
  the reference takes, with nulls, unequal string widths, sliced and
  chunked arrays and empty batches: the same host columns (values,
  validity, string matrices and lengths) and the same arrow tables.
- ``infer_schema`` and ``enumerate_units`` for parquet, ORC and CSV
  (``sep``, ``header``).
- ``_unit_survives`` for eq / lt / le / gt / ge / isnotnull over parquet
  row groups and ORC stripes, null-only units and incomparable stats.
- ``FileScanExec`` partition by partition against the reference's, under
  each reader type, with the scan cache on and off and a pushed
  predicate: the same batches (the port's on ``device="cpu"``, the
  reference's through its device path on XLA:CPU) and the same
  ``numSkippedRowGroups``.
- ``input_file_name()`` per row on both of the port's engines against
  the reference's host engine; a CPU scan is never served a cache entry
  made for another device.
- Where the port parts from the reference: a ``>`` / ``>=`` on a float
  column keeps NaN rows under pushdown, and a device OOM first drops the
  scan cache's entries on the card.

The files are written with pyarrow here, or by the reference's
``tpch.generate`` (scale 0.005, 2 files a table, seed 0).
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.orc as paorc
import pyarrow.parquet as papq
import pytest
import torch

from spark_rapids_tpu.api import TpuSession as JSession
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.columnar.host import device_to_host as j_device_to_host
from spark_rapids_tpu.io import arrow_convert as JA
from spark_rapids_tpu.io import scan as JS
from spark_rapids_tpu.ops.base import ExecContext as JExecContext
from spark_rapids_tpu.plan import logical as JL

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.columnar.host import device_to_host
from spark_rapids_tpu_torch.io import arrow_convert as A
from spark_rapids_tpu_torch.io import scan as S
from spark_rapids_tpu_torch.ops.base import ExecContext
from spark_rapids_tpu_torch.plan import logical as L

N = 37


def _arrays() -> dict:
    rng = np.random.default_rng(0)
    mask = rng.random(N) < 0.25
    words = ["", "a", "bc", "hello world", "ünï", "x" * 23, "zz", "tail"]
    strs = [None if m else words[i % len(words)]
            for i, m in enumerate(mask.tolist())]
    ints = rng.integers(-2 ** 40, 2 ** 40, N)
    floats = rng.normal(size=N)
    floats[3], floats[5], floats[7] = np.nan, np.inf, -0.0
    big = pa.array([words[i % len(words)] * (i % 3) for i in range(90)])
    return {
        "bool": pa.array(rng.random(N) < 0.5, mask=mask),
        "int8": pa.array(rng.integers(-128, 128, N).astype(np.int8),
                         mask=mask),
        "int16": pa.array(rng.integers(-2 ** 15, 2 ** 15, N)
                          .astype(np.int16), mask=mask),
        "int32": pa.array(rng.integers(-2 ** 31, 2 ** 31, N)
                          .astype(np.int32), mask=mask),
        "int64": pa.array(ints, mask=mask),
        "float32": pa.array(floats.astype(np.float32), mask=mask),
        "float64": pa.array(floats, mask=mask),
        "date32": pa.array(rng.integers(-1000, 20000, N).astype(np.int32),
                           mask=mask).cast(pa.date32()),
        "timestamp_s": pa.array(ints // 10 ** 6, mask=mask).cast(
            pa.timestamp("s")),
        "timestamp_ms": pa.array(ints // 1000, mask=mask).cast(
            pa.timestamp("ms")),
        "timestamp_us_utc": pa.array(ints, mask=mask).cast(
            pa.timestamp("us", tz="UTC")),
        "timestamp_ns": pa.array(ints * 1000, mask=mask).cast(
            pa.timestamp("ns")),
        "string": pa.array(strs, type=pa.string()),
        "large_string": pa.array(strs, type=pa.large_string()),
        "binary": pa.array([None if s is None else s.encode()
                            for s in strs], type=pa.binary()),
        "binary_not_utf8": pa.array([b"\xff\xfe", None, b"ok", b"\xc3"]
                                    * 9 + [b""], type=pa.binary()),
        "dictionary": pa.array(strs, type=pa.string()).dictionary_encode(),
        "string_sliced": big.slice(7, N),
        "string_all_null": pa.array([None] * N, type=pa.string()),
    }


ARRAYS = _arrays()


def _same_host_column(got, want, name):
    assert got.dtype.name == want.dtype.name, name
    np.testing.assert_array_equal(np.asarray(got.validity, np.bool_),
                                  np.asarray(want.validity, np.bool_))
    if want.dtype.is_string:
        assert got.str_matrix.shape == want.str_matrix.shape, name
        np.testing.assert_array_equal(got.str_matrix, want.str_matrix)
        np.testing.assert_array_equal(got.str_lengths, want.str_lengths)
        return
    g, w = np.asarray(got.data), np.asarray(want.data)
    assert g.dtype == w.dtype and g.shape == w.shape, name
    assert g.tobytes() == w.tobytes(), name


def _same_host_batch(got, want):
    assert tuple(got.names) == tuple(want.names)
    for n, g, w in zip(got.names, got.columns, want.columns):
        _same_host_column(g, w, n)


@pytest.mark.parametrize("rows", ["full", "empty"])
@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_arrow_round_trip_matches_reference(name, rows):
    arr = ARRAYS[name]
    if rows == "empty":
        arr = arr.slice(0, 0)
    table = pa.table({name: arr, "k": pa.array(np.arange(len(arr)))})
    got = A.arrow_to_host_batch(table)
    assert [(n, t.name) for n, t in A.schema_from_arrow(table.schema)] == \
        [(n, t.name) for n, t in JA.schema_from_arrow(table.schema)]
    if name == "bool":
        # The reference fills a boolean column's nulls with the int 0,
        # which pyarrow refuses, so it reads no boolean column (ROADMAP
        # queue C); the port fills False.
        with pytest.raises(pa.ArrowInvalid):
            JA.arrow_to_host_batch(table)
        c = got.columns[0]
        assert c.to_list() == arr.to_pylist()
        assert not np.asarray(c.data)[~np.asarray(c.validity)].any()
    else:
        _same_host_batch(got, JA.arrow_to_host_batch(table))
    back = A.host_batch_to_arrow(got)
    assert back.equals(JA.host_batch_to_arrow(got)), (back, name)
    if name not in ("binary_not_utf8",) and not name.startswith(
            ("timestamp", "dictionary", "large", "binary")):
        assert back.column(0).equals(table.column(0))
    assert A.dt_to_arrow_type(got.columns[0].dtype) == \
        JA.dt_to_arrow_type(got.columns[0].dtype)


def test_record_batch_and_chunked_tables_match_reference():
    rb = pa.record_batch({"s": ARRAYS["string"], "x": ARRAYS["float64"]})
    _same_host_batch(A.arrow_to_host_batch(rb), JA.arrow_to_host_batch(rb))
    chunked = pa.concat_tables([pa.table({"s": ARRAYS["string"]}),
                                pa.table({"s": ARRAYS["string_sliced"]})])
    assert chunked.column(0).num_chunks == 2
    _same_host_batch(A.arrow_to_host_batch(chunked),
                     JA.arrow_to_host_batch(chunked))


def test_unsupported_arrow_type_raises_as_the_reference():
    t = pa.list_(pa.int32())
    with pytest.raises(TypeError) as got:
        A.arrow_type_to_dt(t)
    with pytest.raises(TypeError) as want:
        JA.arrow_type_to_dt(t)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Schema inference, scan units and stats pruning
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Small parquet (row groups of 10, the second x's null rows), ORC
    (a stripe a file) and CSV files (comma with header, pipe without)."""
    d = tmp_path_factory.mktemp("io_files")
    x = pa.array([*range(10), *([None] * 10), *range(20, 30), *range(5)],
                 type=pa.int64())
    s = pa.array([f"s{i:02d}" if i % 7 else None for i in range(35)])
    f = pa.array(np.linspace(-1, 1, 35))
    table = pa.table({"x": x, "s": s, "f": f})
    out = {"parquet": [], "orc": [], "csv": [], "csv_pipe": []}
    for i in range(2):
        p = str(d / f"t{i}.parquet")
        papq.write_table(table, p, row_group_size=10)
        out["parquet"].append(p)
        o = str(d / f"t{i}.orc")
        # The first ORC file holds only x's null rows.
        paorc.write_table(table.slice(10 + i * 10, 10 + i * 5), o)
        out["orc"].append(o)
        c = str(d / f"t{i}.csv")
        pacsv.write_csv(table, c)
        out["csv"].append(c)
        cp = str(d / f"t{i}.psv")
        pacsv.write_csv(table, cp, pacsv.WriteOptions(
            include_header=False, delimiter="|"))
        out["csv_pipe"].append(cp)
    return out


FORMATS = {"parquet": ("parquet", {}), "orc": ("orc", {}),
           "csv": ("csv", {}),
           "csv_pipe": ("csv", {"sep": "|", "header": "false"})}


@pytest.mark.parametrize("kind", sorted(FORMATS))
def test_infer_schema_and_units_match_reference(kind, files):
    fmt, opts = FORMATS[kind]
    got = S.infer_schema(fmt, files[kind], opts)
    want = JS.infer_schema(fmt, files[kind], opts)
    assert [(n, t.name) for n, t in got] == [(n, t.name) for n, t in want]
    units = S.enumerate_units(fmt, files[kind])
    assert [(u.path, u.index, u.rows) for u in units] == \
        [(u.path, u.index, u.rows) for u in JS.enumerate_units(
            fmt, files[kind])]
    assert len(units) == {"parquet": 8, "orc": 2}.get(fmt, 2)


VALUES = {"x": [-5, 0, 4, 9, 10, 15, 20, 29, 30, 100, "abc", 2.5],
          "s": ["s00", "s01", "s10", "s34", "zzz", "", 7]}


@pytest.mark.parametrize("op", ["eq", "lt", "le", "gt", "ge", "isnotnull"])
@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv"])
def test_unit_survives_matches_reference(fmt, op, files):
    """Every (unit, column, value) of the grid: the same keep / skip,
    with a null-only row group (x in the second) and incomparable values
    (strings against int stats, ints against string stats) kept."""
    units = S.enumerate_units(fmt, files[fmt])
    junits = JS.enumerate_units(fmt, files[fmt])
    got, want = [], []
    for name, values in VALUES.items():
        for v in (values if op != "isnotnull" else [None]):
            pred = [(name, op, v)]
            got.append([S._unit_survives(fmt, u, pred) for u in units])
            want.append([JS._unit_survives(fmt, u, pred) for u in junits])
    assert got == want
    if fmt == "parquet":
        null_group = units[1]
        assert not S._unit_survives(fmt, null_group, [("x", op, 5)])
        assert S._unit_survives(fmt, units[0], [("x", op, "abc")])
    if fmt != "csv":
        assert any(not keep for row in got for keep in row)


def test_orc_stripe_stats_cache_matches_reference(files):
    u = S.enumerate_units("orc", files["orc"])[1]
    ju = JS.enumerate_units("orc", files["orc"])[1]
    stats, rows = S._orc_stripe_stats(u, ["x", "s", "missing"])
    jstats, jrows = JS._orc_stripe_stats(ju, ["x", "s", "missing"])
    assert rows == jrows == 15
    assert sorted(stats) == sorted(jstats) == ["s", "x"]
    for n in stats:
        assert (stats[n].min, stats[n].max, stats[n].null_count) == \
            (jstats[n].min, jstats[n].max, jstats[n].null_count)


# ---------------------------------------------------------------------------
# FileScanExec against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch_io"))
    jtpch.generate(d, scale=0.005, files_per_table=2, seed=0)
    return d


ORDERS = (("o_orderkey", "int64"), ("o_custkey", "int64"),
          ("o_orderdate", "date"), ("o_orderpriority", "string"),
          ("o_shippriority", "int32"))


def _schemas(dt_mod):
    return tuple((n, dt_mod.type_named(t)) for n, t in ORDERS)


def _host_rows(hbs):
    return [row for hb in hbs for row in hb.to_pylist()]


def _scan_pair(data_dir, predicates=(), perfile=False):
    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    paths = tpch._paths(data_dir, "orders")
    port = S.FileScanExec("parquet", paths, _schemas(dt), {},
                          force_perfile=perfile, predicates=predicates,
                          device="cpu")
    ref = JS.FileScanExec("parquet", paths, _schemas(jdt), {},
                          force_perfile=perfile, predicates=predicates)
    return port, ref


READER_CONFS = [(rt, cache) for rt in ("PERFILE", "MULTITHREADED",
                                       "COALESCING", "AUTO")
                for cache in (0, 1 << 30)]


@pytest.mark.parametrize("reader,cache", READER_CONFS)
def test_file_scan_matches_reference(reader, cache, data_dir):
    """Two passes a partition (the second served by the scan cache when it
    is on): the port's batches, downloaded, equal the reference's device
    batches, downloaded, batch for batch; the same skip counts under a
    pushed predicate; the cache serves exactly the units it kept."""
    from spark_rapids_tpu.config import TpuConf as JConf
    raw = {"spark.rapids.sql.format.parquet.reader.type": reader,
           "spark.rapids.sql.format.scanCache.maxBytes": cache,
           "spark.rapids.sql.reader.batchSizeRows": 1000}
    names = [n for n, _ in ORDERS]
    preds = (("o_orderkey", "le", 2000), ("o_custkey", "isnotnull", None))
    S.DEVICE_SCAN_CACHE.clear()
    JS.DEVICE_SCAN_CACHE.clear()
    for predicates in ((), preds):
        port, ref = _scan_pair(data_dir, predicates)
        assert port.num_partitions(None) == ref.num_partitions(None) == 2
        for p in range(2):
            for attempt in range(2):
                ctx = ExecContext(C.TpuConf(raw))
                jctx = JExecContext(JConf(raw))
                got = [device_to_host(b, names)
                       for b in port.execute_device(ctx, p)]
                want = [j_device_to_host(b, names)
                        for b in ref.execute_device(jctx, p)]
                assert len(got) == len(want)
                for g, w in zip(got, want):
                    assert g.to_pylist() == w.to_pylist()
                m = ctx.metrics_for(port).values
                jm = jctx.metrics_for(ref).values
                for key in ("numSkippedRowGroups", "scanCacheHits",
                            "numOutputRows", "numOutputBatches"):
                    assert m.get(key, 0) == jm.get(key, 0), (key, m, jm)
                if predicates:
                    assert m.get("numSkippedRowGroups", 0) == p
                if cache and attempt and reader != "COALESCING":
                    assert m.get("scanCacheHits", 0) == \
                        len(port._units_of(p))
    S.DEVICE_SCAN_CACHE.clear()
    JS.DEVICE_SCAN_CACHE.clear()


def test_host_engine_scan_matches_reference(data_dir):
    port, ref = _scan_pair(data_dir, (("o_orderkey", "gt", 5000),))
    for p in range(2):
        ctx, jctx = ExecContext(), JExecContext()
        got = list(port.execute_host(ctx, p))
        want = list(ref.execute_host(jctx, p))
        assert _host_rows(got) == _host_rows(want)
        for g, w in zip(got, want):
            _same_host_batch(g, w)


def test_cpu_scan_is_never_served_another_devices_entry(data_dir):
    """Entries are keyed by the device: a scan on another device misses
    every unit a CPU scan cached, and the CPU scan hits them all."""
    S.DEVICE_SCAN_CACHE.clear()
    port, _ = _scan_pair(data_dir)
    raw = {"spark.rapids.sql.format.parquet.reader.type": "PERFILE"}
    for p in range(2):
        list(port.execute_device(ExecContext(C.TpuConf(raw)), p))
    rows = port._batch_rows(ExecContext())
    keys = [port._unit_cache_key(u, rows) for u in port._units]
    assert all(k[-1] == "cpu" for k in keys)
    assert all(S.DEVICE_SCAN_CACHE.get(k) is not None for k in keys)
    other = S.FileScanExec("parquet", port.paths, port.schema, {},
                           device="meta")
    for u in other._units:
        assert S.DEVICE_SCAN_CACHE.get(other._unit_cache_key(u, rows)) \
            is None
    ctx = ExecContext(C.TpuConf(raw))
    for b in port.execute_device(ctx, 0):
        assert b.device.type == "cpu"
    assert ctx.metrics_for(port).values["scanCacheHits"] == \
        len(port._units_of(0))
    S.DEVICE_SCAN_CACHE.clear()


# ---------------------------------------------------------------------------
# input_file_name()
# ---------------------------------------------------------------------------

def _file_query(M, session, paths, how):
    df = session.read.parquet(*paths)
    if how == "direct":
        return df.select(M.input_file_name().alias("f"), M.col("o_orderkey"))
    if how == "filtered":
        return df.filter(M.col("o_orderkey") > 100).select(
            M.col("o_orderkey"), M.input_file_name().alias("f"))
    if how == "union":
        other = session.read.parquet(*paths)
        return df.union(other).select(M.input_file_name().alias("f"),
                                      M.col("o_orderkey"))
    # above an exchange: repartition then the file name
    return df.repartition(3).select(M.input_file_name().alias("f"),
                                    M.col("o_orderkey"))


@pytest.mark.parametrize("how", ["direct", "filtered", "union", "exchange"])
def test_input_file_name_matches_reference(how, data_dir):
    paths = tpch._paths(data_dir, "orders")
    jdf = _file_query(JL, JSession({"spark.rapids.sql.shuffle.partitions":
                                    1}), paths, how)
    want = jdf.collect_host()
    df = _file_query(L, TpuSession(device="cpu"), paths, how)
    got_device, got_host = df.collect(), df.collect_host()
    if how == "exchange":
        key = lambda r: (r[1], r[0])   # noqa: E731  (partition order)
        got_device, got_host, want = (sorted(x, key=key) for x in (
            got_device, got_host, want))
    assert got_device == want
    assert got_host == want
    files = {r[0] if how != "filtered" else r[1] for r in want}
    if how in ("direct", "filtered"):
        assert files == set(paths)
        phys = df._physical()
        scans = [e for e in _walk(phys.root)
                 if isinstance(e, S.FileScanExec)]
        assert scans and all(s.force_perfile for s in scans)
    else:
        assert files == {""}


def _walk(e):
    yield e
    for c in e.children:
        yield from _walk(c)


def test_reader_options_and_formats_match_reference(files):
    for kind, (fmt, opts) in sorted(FORMATS.items()):
        reader, jreader = TpuSession(device="cpu").read, JSession().read
        for k, v in opts.items():
            reader, jreader = reader.option(k, v), jreader.option(k, v)
        df = getattr(reader, fmt)(*files[kind])
        jdf = getattr(jreader, fmt)(*files[kind])
        assert [(n, t.name) for n, t in df.schema] == \
            [(n, t.name) for n, t in jdf.schema]
        assert df.collect() == jdf.collect_host(), kind
        assert df.collect_host() == jdf.collect_host(), kind


# ---------------------------------------------------------------------------
# Divergences from the reference: NaN under pushdown, the cache under OOM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["gt", "ge"])
@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_float_range_pushdown_keeps_nan_rows(fmt, op, tmp_path):
    """NaN ranks above every float, so ``x > 5.0`` keeps a NaN row, and
    neither format's min / max sees NaN: the port keeps every unit of a
    ``>`` / ``>=`` on a float column and returns the NaN row, as the
    filter over the same rows in memory does. The reference skips the
    unit and loses the row (ROADMAP queue C)."""
    table = pa.table({"x": pa.array([1.0, np.nan, 2.0, 3.0]),
                      "k": pa.array([0, 1, 2, 3])})
    paths = []
    for i in range(2):
        p = str(tmp_path / f"f{i}.{fmt}")
        (papq if fmt == "parquet" else paorc).write_table(
            table.slice(2 * i, 2), p)
        paths.append(p)
    pred = [("x", op, 5.0)]
    assert [S._unit_survives(fmt, u, pred)
            for u in S.enumerate_units(fmt, paths)] == [True, True]
    assert [JS._unit_survives(fmt, u, pred)
            for u in JS.enumerate_units(fmt, paths)] == [False, False]
    # The integer column's range still skips.
    assert [S._unit_survives(fmt, u, [("k", op, 2)])
            for u in S.enumerate_units(fmt, paths)] == [False, True]

    def cmp(M, x):
        return x > M.lit_col(5.0) if op == "gt" else x >= M.lit_col(5.0)

    session = TpuSession(device="cpu")
    df = getattr(session.read, fmt)(*paths).filter(cmp(L, L.col("x")))
    bound = df._physical()
    scans = [e for e in _walk(bound.root) if isinstance(e, S.FileScanExec)]
    # The plan cache pushes the literal as a bind slot, resolved per run.
    ctx = ExecContext(bound.conf)
    bound.install(ctx)
    assert [s._resolved_predicates(ctx) for s in scans] == \
        [(("x", op, 5.0),)]
    memory = session.create_dataframe(
        {"x": table.column("x").to_numpy(), "k": np.arange(4)},
        df.schema).filter(cmp(L, L.col("x")))
    for rows in (df.collect(), df.collect_host(), memory.collect()):
        assert [r[1] for r in rows] == [1] and np.isnan(rows[0][0])


def test_oom_ladder_drops_the_cards_scan_cache_first(data_dir):
    """A device OOM's first rung drops the scan cache's entries off the
    CPU, which the spill catalog does not hold, and retries; CPU entries
    stay. A cache holding none skips the rung."""
    from spark_rapids_tpu_torch.memory import oom
    S.DEVICE_SCAN_CACHE.clear()
    port, _ = _scan_pair(data_dir)
    raw = {"spark.rapids.sql.format.parquet.reader.type": "PERFILE"}
    for p in range(2):
        list(port.execute_device(ExecContext(C.TpuConf(raw)), p))
    rows = port._batch_rows(ExecContext())
    keys = [port._unit_cache_key(u, rows) for u in port._units]
    # An entry keyed as the card's (its batches are the CPU ones).
    card_key = keys[0][:-1] + ("cuda:0",)
    S.DEVICE_SCAN_CACHE.put(card_key, S.DEVICE_SCAN_CACHE.get(keys[0]),
                            1 << 30)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory.")
        return "ok"

    oom.set_active_catalog(None)
    try:
        assert oom.retry_on_oom(flaky) == "ok"
        assert oom.last_ladder == ["drop-scan-cache"]
        assert S.DEVICE_SCAN_CACHE.get(card_key) is None
        assert all(S.DEVICE_SCAN_CACHE.get(k) is not None for k in keys)
        calls.clear()
        while oom.shrink_batch_target():
            pass                    # leave no other rung that can act
        with pytest.raises(torch.OutOfMemoryError):
            oom.retry_on_oom(flaky)
        assert oom.last_ladder == []
    finally:
        oom.reset_degradation()
        S.DEVICE_SCAN_CACHE.clear()
