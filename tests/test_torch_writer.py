"""Port parity of the writer on the CPU: the port's ``io/writer.py``
``DataFrameWriter`` (``df.write``) against the JAX package's.

Each case writes the same rows from an in-memory DataFrame of both
packages (the port's plan on ``device="cpu"``; the reference's on its host
engine, ``spark.rapids.sql.enabled`` false, which writes what its device
plan writes without XLA compiles) and compares:

- the directory layout (the ``part-NNNNN-<job>`` names with the job id
  taken out), the file counts and ``last_stats``;
- the arrow tables of the files, file for file;
- ``partition_by`` with Hive-escaped and null values;
- the modes (error, overwrite, append);
- the write gate that sends the job to the host engine;
- parquet, ORC and CSV round trips through the port's reader.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)

import os
import re

import numpy as np
import pyarrow.csv as pacsv
import pyarrow.orc as paorc
import pyarrow.parquet as papq
import pytest

from spark_rapids_tpu.api import TpuSession as JSession
from spark_rapids_tpu.columnar import dtypes as jdt

from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.io import writer as W

REF_HOST = {"spark.rapids.sql.enabled": False}
SCHEMA = (("k", "int64"), ("region", "string"), ("price", "float64"),
          ("day", "date"), ("flag", "int32"))


def _rows(n: int = 60, seed: int = 0):
    rng = np.random.default_rng(seed)
    regions = ["east", "west", "a/b", "x=y", "50%", "sp ace", None, "ü"]
    out = []
    for i in range(n):
        out.append((int(i * 7 - 30),
                    regions[int(rng.integers(0, len(regions)))],
                    None if i % 11 == 5 else float(rng.normal()),
                    int(rng.integers(8000, 11000)),
                    int(rng.integers(0, 3)) if i % 13 else None))
    return out


def _schema(mod):
    return tuple((n, mod.type_named(t)) for n, t in SCHEMA)


def _frames(rows, parts=3, port_conf=None, ref_conf=None):
    port = TpuSession(dict(port_conf or {}), device="cpu") \
        .create_dataframe(rows, _schema(dt), num_partitions=parts)
    ref = JSession(dict(REF_HOST, **(ref_conf or {}))) \
        .create_dataframe(rows, _schema(jdt), num_partitions=parts)
    return port, ref


def _layout(root: str):
    """Relative file paths with each part file's job id taken out."""
    out = []
    for d, _dirs, fs in os.walk(root):
        for f in fs:
            rel = os.path.relpath(os.path.join(d, f), root)
            out.append(re.sub(r"part-(\d{5})-[0-9a-f]{8}", r"part-\1", rel))
    return sorted(out)


def _read(path: str):
    if path.endswith(".parquet"):
        return papq.read_table(path)
    if path.endswith(".orc"):
        return paorc.read_table(path)
    return pacsv.read_csv(path)


def _same_files(got_root: str, want_root: str):
    assert _layout(got_root) == _layout(want_root)
    got = {re.sub(r"-[0-9a-f]{8}\.", ".", os.path.relpath(
        os.path.join(d, f), got_root)): os.path.join(d, f)
        for d, _, fs in os.walk(got_root) for f in fs}
    want = {re.sub(r"-[0-9a-f]{8}\.", ".", os.path.relpath(
        os.path.join(d, f), want_root)): os.path.join(d, f)
        for d, _, fs in os.walk(want_root) for f in fs}
    for rel in got:
        assert _read(got[rel]).equals(_read(want[rel])), rel


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv"])
def test_write_matches_reference(fmt, parts, tmp_path):
    port, ref = _frames(_rows(), parts)
    got = getattr(port.write, fmt)(str(tmp_path / "port"))
    want = getattr(ref.write, fmt)(str(tmp_path / "ref"))
    assert got == want
    assert got["numFiles"] == parts and got["numOutputRows"] == 60
    _same_files(str(tmp_path / "port"), str(tmp_path / "ref"))


@pytest.mark.parametrize("keys", [("region",), ("flag",), ("region", "flag"),
                                  ("price",)])
def test_partition_by_matches_reference(keys, tmp_path):
    port, ref = _frames(_rows(), 2)
    w, jw = port.write.partition_by(*keys), ref.write.partitionBy(*keys)
    got = w.parquet(str(tmp_path / "port"))
    want = jw.parquet(str(tmp_path / "ref"))
    assert got == want == w.last_stats
    assert got["numParts"] > 1
    _same_files(str(tmp_path / "port"), str(tmp_path / "ref"))
    layout = _layout(str(tmp_path / "port"))
    if keys == ("region",):
        assert "region=a%2Fb/part-00000.parquet" in layout
        assert "region=x%3Dy/part-00000.parquet" in layout
        assert "region=50%25/part-00001.parquet" in layout
        assert any(p.startswith("region=__HIVE_DEFAULT_PARTITION__/")
                   for p in layout)


def test_part_values_match_reference():
    from spark_rapids_tpu.io import writer as JW
    for v in (None, "a/b", b"x=y", 1.0, 2.5, float("nan"), -3, "",
              "\x01tab\t", "#%'*:?\\{[]^\x7f"):
        assert W._part_value(v) == JW._part_value(v)


def test_empty_partition_writes_a_schema_only_file(tmp_path):
    rows = _rows(2)
    port, ref = _frames(rows, 4)
    got = port.write.parquet(str(tmp_path / "port"))
    want = ref.write.parquet(str(tmp_path / "ref"))
    assert got == want and got["numFiles"] == 4
    _same_files(str(tmp_path / "port"), str(tmp_path / "ref"))
    root = str(tmp_path / "port")
    tables = [papq.read_table(os.path.join(root, f))
              for f in sorted(os.listdir(root))]
    assert [t.num_rows for t in tables] == [1, 1, 0, 0]
    assert all(t.schema == tables[0].schema for t in tables)


def test_modes_match_reference(tmp_path):
    port, ref = _frames(_rows(), 2)
    for name, df in (("port", port), ("ref", ref)):
        path = str(tmp_path / name)
        df.write.parquet(path)
        with pytest.raises(FileExistsError):
            df.write.parquet(path)
        df.write.mode("append").parquet(path)
        assert len(os.listdir(path)) == 4
        stats = df.write.mode("overwrite").parquet(path)
        assert len(os.listdir(path)) == 2 and stats["numFiles"] == 2
    assert _layout(str(tmp_path / "port")) == _layout(str(tmp_path / "ref"))


@pytest.mark.parametrize("fmt,gate", [
    ("parquet", "spark.rapids.sql.format.parquet.write.enabled"),
    ("orc", "spark.rapids.sql.format.orc.write.enabled")])
def test_write_gate_runs_the_host_engine(fmt, gate, tmp_path, monkeypatch):
    """Gate off: the port plans the job on the host engine (no device
    execute) and writes what the gate-on job writes."""
    port, ref = _frames(_rows(), 2, port_conf={gate: False},
                        ref_conf={gate: False})
    from spark_rapids_tpu_torch.ops.base import InMemorySourceExec

    def no_device(*a, **k):
        raise AssertionError("the gated write ran on the device")
    monkeypatch.setattr(InMemorySourceExec, "execute_device", no_device)
    got = getattr(port.write, fmt)(str(tmp_path / "port"))
    want = getattr(ref.write, fmt)(str(tmp_path / "ref"))
    assert got == want
    _same_files(str(tmp_path / "port"), str(tmp_path / "ref"))
    monkeypatch.undo()
    on, _ = _frames(_rows(), 2)
    getattr(on.write, fmt)(str(tmp_path / "on"))
    _same_files(str(tmp_path / "port"), str(tmp_path / "on"))


@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv"])
def test_round_trip_through_the_reader(fmt, tmp_path):
    rows = _rows(40)
    if fmt == "csv":
        # CSV infers its types back: no nulls in the int and float columns
        # (an empty cell of an int column reads back as a string column).
        rows = [(k, r, p if p is not None else 0.5, d, f or 0)
                for k, r, p, d, f in rows]
    port, _ = _frames(rows, 2)
    path = str(tmp_path / fmt)
    getattr(port.write, fmt)(path)
    files = sorted(os.path.join(path, f) for f in os.listdir(path))
    session = TpuSession(device="cpu")
    back = getattr(session.read, fmt)(*files)
    got = back.collect()
    if fmt == "csv":
        # A null string reads back as "" (pyarrow's CSV default), and the
        # int32 column as int64.
        assert got == [(k, "" if r is None else r, p, d, f)
                       for k, r, p, d, f in rows]
        assert [(n, t.name) for n, t in back.schema] == [
            (n, "int64" if t == "int32" else t) for n, t in SCHEMA]
    else:
        assert got == rows
        assert [(n, t.name) for n, t in back.schema] == list(SCHEMA)
