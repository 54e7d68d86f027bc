"""Port parity: the wire codec (``columnar/wire.py``) and kernel K4's plain
version against the JAX package, on the CPU.

- Encode: the port's specs and staging bytes equal the JAX package's
  ``wire.pack_batch`` output byte for byte under ``plain``, ``v1`` and
  ``v2``: over the dtype ladder (random and sorted), the codec's edge
  cases, and every scan of TPC-H q1-q4 at scale 0.002.
- Decode: the port's ``upload(..., device="cpu")`` lands the JAX
  ``wire.upload`` buffers (data, validity, lengths, num_rows), and the same
  buffers as the port's ``plain`` upload, in every mode; grouped uploads
  equal per-batch ones, and a source groups them by
  ``wire.minUploadBytes`` and packs each partition once per mode.
- K4: ``native.rle_decode_plain`` equals the JAX Pallas ``rle_decode``
  under ``native.forced()`` (interpret mode), and a Python emulation of the
  CUDA kernel's block-window design equals the plain version.
- The codec conf key and env, and import hygiene (no jax, no pandas).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar import host as jhost
from spark_rapids_tpu.columnar import wire as jwire
from spark_rapids_tpu.ops import native as jnative

from spark_rapids_tpu_torch import entry as E
from spark_rapids_tpu_torch.columnar import batch as tbatch
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar import host as thost
from spark_rapids_tpu_torch.columnar import wire as twire
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.ops import ExecContext
from spark_rapids_tpu_torch.ops import native as tnative

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from data_gen import ALL_GENS, gen_batch  # noqa: E402
from test_torch_probe import kary_count  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
MODES = ("plain", "v1", "v2")


@pytest.fixture
def codec(monkeypatch):
    """Set one codec mode in both packages for the test."""
    def set_mode(mode):
        monkeypatch.setattr(jwire, "_CODEC_OVERRIDE", mode)
        monkeypatch.setattr(twire, "_CODEC_OVERRIDE", mode)
    return set_mode


def _port_batch(jhb):
    """The JAX host batch as a port host batch (same arrays)."""
    cols = []
    for c in jhb.columns:
        t = tdt.type_named(c.dtype.name)
        cols.append(thost.HostColumn(t, c.data, c.validity,
                                     str_matrix=c.str_matrix,
                                     str_lengths=c.str_lengths))
    return thost.HostBatch(tuple(jhb.names), cols)


def _jax_batch(thb):
    cols = []
    for c in thb.columns:
        t = jdt.type_named(c.dtype.name)
        cols.append(jhost.HostColumn(t, c.data, c.validity,
                                     str_matrix=c.str_matrix,
                                     str_lengths=c.str_lengths))
    return jhost.HostBatch(tuple(thb.names), cols)


def _bits(a):
    a = np.asarray(a)
    return a if a.dtype == np.bool_ else a.view(np.uint8)


def assert_device_equal(jb, tb, msg=""):
    """JAX DeviceBatch vs port DeviceBatch, buffer for buffer (bit views,
    so -0.0 and NaN payloads count)."""
    assert jb.capacity == tb.capacity, msg
    assert int(jb.num_rows) == int(tb.num_rows), msg
    assert tb.num_rows.dtype == torch.int32 and tb.num_rows.dim() == 0
    for i, (jc, tc) in enumerate(zip(jb.columns, tb.columns)):
        assert jc.dtype.name == tc.dtype.name, msg
        for what, w, g in (("data", jc.data, tc.data),
                           ("validity", jc.validity, tc.validity)):
            w, g = np.asarray(w), g.numpy()
            assert w.dtype == g.dtype and w.shape == g.shape, \
                (msg, i, what, w.dtype, g.dtype, w.shape, g.shape)
            assert np.array_equal(_bits(w), _bits(g)), (msg, i, what)
        if jc.dtype.is_string:
            assert tc.lengths.dtype == torch.int32
            np.testing.assert_array_equal(
                np.asarray(jc.lengths).astype(np.int32), tc.lengths.numpy())


def assert_port_equal(a, b, msg=""):
    assert a.capacity == b.capacity and int(a.num_rows) == int(b.num_rows)
    for i, (x, y) in enumerate(zip(a.columns, b.columns)):
        assert x.dtype == y.dtype, msg
        assert x.data.dtype == y.data.dtype, (msg, i)
        assert np.array_equal(_bits(x.data.numpy()), _bits(y.data.numpy())), \
            (msg, i)
        assert torch.equal(x.validity, y.validity), (msg, i)
        if x.lengths is not None:
            assert torch.equal(x.lengths, y.lengths), (msg, i)


def assert_encode_equal(jhb, thb, msg=""):
    je, te = jwire.pack_batch(jhb), twire.pack_batch(thb)
    assert je.specs == te.specs, (msg, je.specs, te.specs)
    assert (je.n, je.cap) == (te.n, te.cap), msg
    assert je.staging.dtype == te.staging.dtype == np.uint8
    assert np.array_equal(je.staging, te.staging), msg
    return te


def check_batch(jhb, mode, codec, msg="", decode=True):
    """Encode parity, then (``decode``) the port's upload against the JAX
    upload and against the port's own plain upload."""
    codec(mode)
    thb = _port_batch(jhb)
    te = assert_encode_equal(jhb, thb, f"{msg} {mode}")
    if not decode:
        return te
    tb = twire.upload(thb, device=CPU)
    assert tb.rows_hint == thb.num_rows
    assert_device_equal(jwire.upload(jhb), tb, f"{msg} {mode}")
    codec("plain")
    assert_port_equal(twire.upload(thb, device=CPU), tb, f"{msg} {mode}")
    return te


# ---------------------------------------------------------------------------
# Encode + decode parity: the dtype ladder
# ---------------------------------------------------------------------------

def _sorted_variant(jhb):
    import math
    vals = jhb.columns[0].to_list()
    nn = [v for v in vals if v is not None]
    nn.sort(key=lambda v: (isinstance(v, float) and math.isnan(v), v))
    return jhost.HostBatch.from_pydict(
        [("x", jhb.columns[0].dtype)], {"x": nn + [None] * 4})


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gen", ALL_GENS, ids=lambda g: g.dtype.name)
@pytest.mark.parametrize("variant", ["random", "sorted"])
def test_dtype_ladder(gen, variant, mode, codec):
    """As tests/test_wire.py's property test: adversarial random data and
    its sorted (RLE/delta-friendly) variant."""
    jhb = gen_batch([("x", gen)], 96, seed=17)
    if variant == "sorted":
        jhb = _sorted_variant(jhb)
    check_batch(jhb, mode, codec, f"{gen.dtype.name} {variant}")


def _col(name, vals):
    return jhost.HostBatch.from_pydict([("x", jdt.type_named(name))],
                                       {"x": vals})


def _hi_card(base, kind=None):
    if kind == "str":
        return list(base) + [f"filler-{i}" for i in range(1200)]
    return list(base) + [float(i) + 0.5 if kind == "f" else (10 + i)
                         for i in range(1200)]


# Edge cases of tests/test_wire.py:238-352 and the codec's other branches:
# (name, logical type, values, expected v2 spec kind or None).
EDGE_CASES = [
    ("rle_sorted_floats", "float64",
     [1.5] * 30 + [2.25] * 30 + [None] * 4 + [7.0] * 30, "rle"),
    ("rle_bit_view_zero_nan", "float64",
     [-0.0] * 12 + [0.0] * 12 + [float("nan")] * 12 + [1e300] * 12, "rle"),
    ("rle_f32_nan_payloads", "float32",
     [float(np.array(0x7FC00123, np.uint32).view(np.float32))] * 20
     + [-0.0] * 20 + [float("nan")] * 20, "rle"),
    ("rle_bool", "bool", [True] * 40 + [False] * 40 + [None] * 8, "rle"),
    ("delta_monotone", "int64", [2 ** 40 + 7 * i for i in range(64)],
     "delta"),
    ("delta_overflow_declines", "int64",
     [-(2 ** 62), 2 ** 62, -(2 ** 62), 2 ** 62] * 16, None),
    ("delta_wraps_int64", "int64",
     [2 ** 63 - 9 + i for i in range(9)]
     + [-(2 ** 63) + i for i in range(40)], "delta"),
    ("for_uint16", "int64",
     (10 ** 15 + np.random.default_rng(0).integers(0, 40_000, 64)).tolist(),
     "for"),
    ("for_uint8", "int64",
     (10 ** 15 + np.random.default_rng(1).integers(0, 200, 64)).tolist(),
     "for"),
    ("for_uint32", "int64",
     (10 ** 15 + np.random.default_rng(2).integers(0, 3 * 10 ** 9, 64))
     .tolist(), "for"),
    ("dict_declines_negative_zero", "float64",
     [-0.0] + [0.01 * i for i in range(11)] * 20, "num"),
    ("dict_float", "float64",
     ([0.01 * i for i in range(11)] + [None]) * 20, "dnum"),
    ("dict_int_no_zero", "int64", [2 ** 40, -2 ** 40, 7, None] * 40,
     "dnum"),
    ("dict_str_zero_code", "string",
     (["MAIL", "SHIP", None, "AIR"] * 50)[:-1] + ["RAIL"], "dstr"),
    ("dict_str_with_empty", "string", ["", "ab", "c", None] * 30, "dstr"),
    ("dict_str_no_empty", "string", ["ab", "c", "xyz"] * 30, "dstr"),
    ("dict_str_high_bytes", "string",
     [b"\xff", b"\x80a", b"a", b"\x7f", b"\x00b"] * 30, "dstr"),
    ("dict_str_wide_high_bytes", "string",
     [b"\xffwide-key-1", b"\x80wide-key-1", b"awide-key-1", b"\x7f" * 20,
      b"wide-key-1\xff", b"wide-key-1\x01", None] * 20, "dstr"),
    ("dict_str_long_int32_lengths", "string",
     ["x" * 40000, "short", None], "dstr"),
    ("str_hi_card", "string", _hi_card(["a", None, "bcd"], "str"), "str"),
    ("num_hi_card_f32", "float64",
     _hi_card([0.5, 0.25, 1.0 + 2 ** -20], "f"), "num"),
    ("date_narrows", "date", [8766, 9131, None, 10956], "num"),
    ("empty", "float64", [], "num"),
    ("all_null", "int32", [None] * 20, None),
]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_edge_cases(case, mode, codec):
    _, name, vals, kind = case
    te = check_batch(_col(name, vals), mode, codec, case[0])
    if mode == "v2" and kind is not None:
        assert te.specs[0][0] == kind, te.specs
    if mode == "plain":
        assert te.specs[0][0] in ("num", "str")


def _many_distinct_rows(n, distinct, seed):
    """n rows cycling over ``distinct`` values, the first appearance of
    some of them past the 65,536-row dictionary sample."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, distinct // 2, 1 << 16)
    tail = rng.integers(0, distinct, n - len(head))
    return np.concatenate([head, tail])


@pytest.mark.parametrize("kind", ["int64", "float64", "short_str",
                                  "wide_str"])
def test_dictionary_beyond_the_sample(kind, codec):
    """Distinct values that first appear after the 65,536-row sample send
    the port's factorization to its whole-column fallback; more than 4,096
    distinct values decline the dictionary. Both as the reference."""
    for distinct, n in ((600, 70_000), (5000, 72_000)):
        codes = _many_distinct_rows(n, distinct, seed=distinct)
        if kind == "int64":
            vals = (codes * 1_000_003 + 10 ** 12).tolist()
        elif kind == "float64":
            vals = (codes * 0.37 + 0.01).tolist()
        elif kind == "short_str":
            vals = [f"{c:x}" for c in codes]
        else:
            vals = [f"wide-value-{c:06d}" for c in codes]
        name = "string" if kind.endswith("str") else kind
        te = check_batch(_col(name, vals), "v2", codec, kind, decode=False)
        assert te.specs[0][0] == ("str" if distinct > 4096 and
                                  name == "string" else te.specs[0][0])


def test_wide_string_fold_collision_falls_back(monkeypatch, codec):
    """A wide string key whose probe folds collide (forced here by a zero
    multiplier, so the probe is the last word alone) must fall back to the
    reference's void-key probe with the same codes."""
    monkeypatch.setattr(twire, "_FOLD", np.uint64(0))
    vals = [f"{p}-common-tail" for p in ("aaa", "bbb", "ccc")] * 30
    te = check_batch(_col("string", vals), "v2", codec, "collision")
    assert te.specs[0][0] == "dstr"


# ---------------------------------------------------------------------------
# TPC-H q1-q4 scans at scale 0.002
# ---------------------------------------------------------------------------

def _tpch_scans():
    cols = E.tpch_columns(0.002, seed=0)
    scans = {"q1_lineitem": E.table_partitions(cols["lineitem"],
                                               E.Q1_SCHEMA, 8)}
    for q, fn in (("q3", E.tpch_q3_tables), ("q4", E.tpch_q4_tables),
                  ("q2", E.tpch_q2_tables)):
        for name, parts in fn(cols).items():
            scans[f"{q}_{name}"] = parts
    return scans


_SCANS = _tpch_scans()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("scan", sorted(_SCANS))
def test_tpch_scans(scan, mode, codec):
    """Every partition encodes to the JAX bytes; the first one also
    uploads to the JAX buffers and the port's plain ones."""
    for i, part in enumerate(_SCANS[scan]):
        for hb in part:
            te = check_batch(_jax_batch(hb), mode, codec, f"{scan}[{i}]",
                             decode=i == 0)
            if scan == "q3_orders" and mode == "v2":
                specs = dict(zip(hb.names, te.specs))
                assert specs["o_shippriority"][0] == "rle", specs


# ---------------------------------------------------------------------------
# Staging: grouped uploads, the group plan, layout
# ---------------------------------------------------------------------------

def test_grouped_upload_bit_identical(codec):
    codec("v2")
    hbs = _small_batches(6)
    solo = [twire.upload_packed(twire.pack_batch(hb), CPU) for hb in hbs]
    grouped = twire.upload_packed_group([twire.pack_batch(hb) for hb in hbs],
                                        CPU)
    assert len(grouped) == len(solo)
    for a, b in zip(solo, grouped):
        assert_port_equal(a, b, "grouped")
        assert b.rows_hint == a.rows_hint == 12
    assert twire.upload_packed_group([], CPU) == []


_SMALL_SCHEMA = (("a", tdt.INT64), ("b", tdt.FLOAT64), ("s", tdt.STRING))


def _small_batches(count):
    return [thost.HostBatch.from_pydict(
        list(_SMALL_SCHEMA),
        {"a": [i, None, i + 2] * 4, "b": [i + 0.5, 0.25 * i, None] * 4,
         "s": ["x" * i, None, "yz"] * 4}) for i in range(count)]


@pytest.mark.parametrize("min_bytes", [0, 1, 600, 1 << 20])
def test_source_groups_uploads_by_min_upload_bytes(min_bytes, monkeypatch):
    """InMemorySourceExec ships each partition's packed batches in the
    groups plan_upload_groups gives for wire.minUploadBytes; the rows are
    the same whatever the grouping."""
    monkeypatch.setattr(twire, "_CODEC_OVERRIDE", None)
    hbs = _small_batches(6)
    parts = [hbs[:4], hbs[4:]]
    plan = E.InMemorySourceExec(_SMALL_SCHEMA, parts, device=CPU)
    conf = TpuConf({"spark.rapids.sql.wire.minUploadBytes": min_bytes})
    twire.reset_counters()
    rows = plan.collect(ExecContext(conf))
    assert rows == [r for hb in hbs for r in hb.to_pylist()]
    want = sum(len(twire.plan_upload_groups(
        [e.nbytes for e in plan.packed(p)], min_bytes)) for p in range(2))
    c = twire.counters()
    assert c["uploadedBatches"] == 6 and c["uploadTransfers"] == want
    assert want == {0: 6, 1: 6, 1 << 20: 2}.get(min_bytes, want)


@pytest.mark.parametrize("mode", MODES)
def test_source_packs_once_per_codec_mode(mode, monkeypatch):
    """A second collect under the same codec reuses the source's packed
    batches (no encode, no pack); another mode packs its own."""
    monkeypatch.setattr(twire, "_CODEC_OVERRIDE", None)
    hbs = _small_batches(3)
    plan = E.InMemorySourceExec(_SMALL_SCHEMA, [hbs], device=CPU)
    want = [r for hb in hbs for r in hb.to_pylist()]
    conf = TpuConf({"spark.rapids.sql.wire.codec": mode})
    other = TpuConf({"spark.rapids.sql.wire.codec":
                     "plain" if mode != "plain" else "v2"})
    for ctx_conf, packs in ((conf, 3), (conf, 0), (other, 3), (conf, 0)):
        twire.reset_counters()
        assert plan.collect(ExecContext(ctx_conf)) == want
        c = twire.counters()
        assert c.get("stagingBuffers", 0) == packs
        assert c["uploadedBatches"] == 3


@pytest.mark.parametrize("seed", range(4))
def test_plan_upload_groups_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        sizes = rng.integers(0, 3000, rng.integers(0, 30)).tolist()
        min_bytes = int(rng.integers(0, 4000))
        assert twire.plan_upload_groups(sizes, min_bytes) == \
            jwire.plan_upload_groups(sizes, min_bytes)


def test_layout_matches_reference(codec):
    codec("v2")
    jhb = gen_batch([(f"c{i}", g) for i, g in enumerate(ALL_GENS)], 70,
                    seed=3)
    te = twire.pack_batch(_port_batch(jhb))
    assert twire._batch_layout(te.cap, te.specs) == \
        jwire._batch_layout(te.cap, te.specs)
    for off, _name, _shape, _nbytes in twire._batch_layout(te.cap,
                                                           te.specs)[0]:
        assert off % 8 == 0


def test_counters_record_codec_choices(codec):
    codec("v2")
    twire.reset_counters()
    hb = _port_batch(_col("float64", [3.5] * 40))
    twire.upload(hb, device=CPU)
    c = twire.counters()
    assert c["codecCols.rle"] == 1
    assert c["uploadTransfers"] == c["uploadedBatches"] == 1
    # 3.5 is exact in float32: a run table of 8 (float32 value, int32 end)
    assert c["rawBytes"] == 48 * 9 and c["encodedBytes"] == 8 * (4 + 4)
    assert c["wireCompressionRatio"] == round(48 * 9 / 64, 4)


def test_host_to_device_goes_through_the_codec(codec, monkeypatch):
    codec("v2")
    calls = []
    upload = twire.upload

    def spy(*args, **kw):
        calls.append(args)
        return upload(*args, **kw)
    monkeypatch.setattr(twire, "upload", spy)
    hb = _port_batch(_col("int32", [0] * 50))
    db = thost.host_to_device(hb, device=CPU)
    assert len(calls) == 1 and db.rows_hint == 50


# ---------------------------------------------------------------------------
# K4: the plain version against the Pallas kernel, and the CUDA design
# ---------------------------------------------------------------------------

RLE_POOLS = [
    ("int8", np.int8, [1, 2, -3]),
    ("int16", np.int16, [100, -2000]),
    ("int32", np.int32, [7, -9, 2 ** 30]),
    ("int64", np.int64, [2 ** 40, -5, 0]),
    ("float32", np.float32, [1.5, -0.0, np.nan, 0.0,
                             np.array(0x7FC00123, np.uint32)
                             .view(np.float32)]),
    ("float64", np.float64, [np.nan, -0.0, 0.0, 3.25, np.inf,
                             np.array(0x7FF8000000000123, np.uint64)
                             .view(np.float64)]),
]


def _run_table(dtype, pool, n, cap, runs, rng, run_cap=None):
    """A run table as ``_try_rle`` builds it: ``runs`` runs of random
    lengths over n rows, padding runs of value 0 ending at cap, in a
    table of ``run_cap`` entries (default the capacity rung of ``runs``)."""
    run_cap = run_cap or tbatch.bucket_capacity(max(runs, 1))
    cuts = np.sort(rng.choice(np.arange(1, n), runs - 1, replace=False)) \
        if runs > 1 else np.zeros(0, np.int64)
    vals = np.zeros(run_cap, dtype)
    vals[:runs] = np.asarray(pool, dtype)[rng.integers(0, len(pool), runs)]
    ends = np.full(run_cap, cap, np.int32)
    ends[:runs - 1] = cuts
    ends[runs - 1] = n
    return vals, ends


# (cap, n, runs): one run, cap > n, a full table (runs == run_cap), 384-row
# Pallas blocks.
RLE_SHAPES = [(64, 50, 1), (64, 50, 5), (64, 50, 8), (768, 700, 48),
              (768, 768, 128), (1536, 1500, 375)]


@pytest.mark.parametrize("shape", RLE_SHAPES, ids=str)
@pytest.mark.parametrize("name,dtype,pool", RLE_POOLS,
                         ids=[p[0] for p in RLE_POOLS])
def test_rle_plain_matches_pallas(name, dtype, pool, shape):
    cap, n, runs = shape
    rng = np.random.default_rng(cap + runs)
    vals, ends = _run_table(dtype, pool, n, cap, runs, rng)
    with jnative.forced():
        want = np.asarray(jnative.rle_decode(
            jnp.asarray(vals), jnp.asarray(ends), cap,
            jnp.asarray(n, jnp.int32)))
    got = tnative.rle_decode(torch.from_numpy(vals), torch.from_numpy(ends),
                             cap, n).numpy()
    assert got.dtype == want.dtype and got.shape == (cap,)
    assert np.array_equal(_bits(want), _bits(got)), name


def _run_of(e, n, r):
    lo, hi = 0, n
    while lo < hi:
        mid = (lo + hi) >> 1
        if e[mid] <= r:
            lo = mid + 1
        else:
            hi = mid
    return min(lo, n - 1)


def _emulate_k4(vals, ends, cap, num_rows, threads, smem_runs):
    """csrc/rle_decode.cu step by step: blocks of ``threads`` threads over
    ``threads`` * 16 rows whatever the element size, in 16-byte chunks,
    chunk c of thread t at chunk c * threads + t. A table of at most
    ``smem_runs`` runs is staged whole by every block, with no search; a
    larger one gives each block its window of runs from two 32-lane
    cooperative searches (search.cuh ``kary_count``, emulated in
    test_torch_probe.py), staged when the window holds at most
    ``smem_runs`` runs. Then one search per chunk for its first row, and
    the walk."""
    g = 16 // vals.itemsize
    block_rows = threads * 16
    out = np.zeros(cap, vals.dtype)
    run_cap = len(vals)
    ends_list = ends.tolist()
    for r0 in range(0, cap, block_rows):
        r1 = min(r0 + block_rows, cap)
        i0, w = 0, run_cap
        if run_cap > smem_runs:
            first, last = (min(kary_count(ends_list, run_cap,
                                          lambda e, r=r: e <= r),
                               run_cap - 1) for r in (r0, r1 - 1))
            assert first == _run_of(ends, run_cap, r0)
            i0, w = first, last - first + 1
        e, v = ends[i0:i0 + w], vals[i0:i0 + w]
        if w > smem_runs:           # device memory: the same arrays
            e, v = ends[i0:], vals[i0:]
        for t in range(threads):
            for c in range(16 // g):
                row = r0 + (c * threads + t) * g
                if row >= cap:
                    break
                i = _run_of(e, w, row)
                for k in range(g):
                    r = row + k
                    while i < w - 1 and e[i] <= r:
                        i += 1
                    if r < cap:
                        out[r] = v[i] if r < num_rows else 0
    return out


@pytest.mark.parametrize("threads,smem_runs", [(4, 2048), (2, 3), (8, 1)])
@pytest.mark.parametrize("name,dtype,pool", RLE_POOLS[::2] + RLE_POOLS[5:],
                         ids=lambda p: p if isinstance(p, str) else "")
def test_k4_design_matches_plain(name, dtype, pool, threads, smem_runs):
    """The kernel's staging, window searches, clamp and walk give the
    plain version's rows, whole table or window, staged or not, across
    block edges, for every element size; and at tables of ``smem_runs``
    - 1, ``smem_runs`` and ``smem_runs`` + 1 runs, full or padded."""
    rng = np.random.default_rng(threads * 7 + smem_runs)
    cases = [(96, 90, 1, None), (96, 90, 40, None), (96, 96, 96, None),
             (200, 150, 8, None), (384, 383, 96, None)]
    for run_cap in (smem_runs - 1, smem_runs, smem_runs + 1):
        if run_cap >= 1:
            cap = max(96, run_cap + 40)
            cases += [(cap, run_cap + 20, run_cap, run_cap),
                      (cap, cap - 7, max(run_cap - 1, 1), run_cap)]
    for cap, n, runs, run_cap in cases:
        vals, ends = _run_table(dtype, pool, n, cap, runs, rng, run_cap)
        want = tnative.rle_decode_plain(torch.from_numpy(vals),
                                        torch.from_numpy(ends), cap,
                                        n).numpy()
        got = _emulate_k4(vals, ends, cap, n, threads, smem_runs)
        assert np.array_equal(_bits(want), _bits(got)), (name, cap, runs)


def test_rle_decode_routes_by_device(monkeypatch):
    def boom(*args):
        raise AssertionError("K4 launched for a CPU tensor")
    monkeypatch.setattr(tnative, "rle_expand", boom)
    tnative.reset_counters()
    vals = torch.tensor([True, False, False, False, False, False, False,
                         False])
    ends = torch.tensor([5, 9, 12, 12, 12, 12, 12, 12], dtype=torch.int32)
    out = tnative.rle_decode(vals, ends, 12, 9)
    assert out.dtype == torch.bool
    assert out.tolist() == [True] * 5 + [False] * 7
    assert tnative.counters()["rle_decode"] == 0


def test_k4_entry_refuses_cpu_tensors():
    vals = torch.zeros(8, dtype=torch.int8)
    ends = torch.full((8,), 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tnative.rle_expand(vals, ends, 16, torch.empty(16, dtype=torch.int8))


# ---------------------------------------------------------------------------
# Conf adoption and import hygiene
# ---------------------------------------------------------------------------

def test_codec_conf_and_env(monkeypatch):
    monkeypatch.setattr(twire, "_CODEC_OVERRIDE", None)
    monkeypatch.delenv("SRT_WIRE_CODEC", raising=False)
    assert twire.codec_mode() == "v2"
    monkeypatch.setenv("SRT_WIRE_CODEC", "plain")
    assert twire.codec_mode() == "plain"
    monkeypatch.setenv("SRT_WIRE_CODEC", "bogus")
    assert twire.codec_mode() == "v2"
    twire.maybe_configure(TpuConf({"spark.rapids.sql.wire.codec": " V1 "}))
    assert twire.codec_mode() == "v1"
    with pytest.raises(ValueError, match="unknown wire codec"):
        twire.maybe_configure(TpuConf({"spark.rapids.sql.wire.codec": "lz4"}))
    twire.maybe_configure(TpuConf())
    monkeypatch.delenv("SRT_WIRE_CODEC")
    assert twire.codec_mode() == "v2"


def test_collect_adopts_the_query_codec(monkeypatch):
    monkeypatch.setattr(twire, "_CODEC_OVERRIDE", None)
    hb = _port_batch(_col("float64", [1.5] * 64))
    plan = E.InMemorySourceExec((("x", tdt.FLOAT64),), [[hb]], device=CPU)
    for mode, kind in (("plain", "num"), ("v2", "rle"), ("v1", "dnum")):
        twire.reset_counters()
        rows = plan.collect(ExecContext(TpuConf(
            {"spark.rapids.sql.wire.codec": mode})))
        assert rows == [(1.5,)] * 64
        assert twire.counters()[f"codecCols.{kind}"] == 1, mode
    plan.collect(ExecContext())
    assert twire._CODEC_OVERRIDE is None


def test_wire_conf_entries():
    from spark_rapids_tpu import config as JC
    from spark_rapids_tpu_torch import config as C
    for port, ref in ((C.WIRE_CODEC, JC.WIRE_CODEC),
                      (C.WIRE_MIN_UPLOAD_BYTES, JC.WIRE_MIN_UPLOAD_BYTES)):
        assert port.key == ref.key and port.default == ref.default
    assert C.WIRE_CODEC.value_type == "string"
    assert TpuConf({C.WIRE_CODEC.key: "plain"}).get(C.WIRE_CODEC) == "plain"
    assert TpuConf().get(C.WIRE_MIN_UPLOAD_BYTES) == 1 << 20


def test_wire_imports_no_jax_or_pandas():
    code = ("import sys\n"
            "import spark_rapids_tpu_torch.columnar.wire\n"
            "import spark_rapids_tpu_torch.columnar.host\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'pandas', 'spark_rapids_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
