"""Port parity: the partitionings, the shuffle exchange, and the hash and
modulo expressions it rests on, against the JAX package on the CPU.

- ``partition_ids`` (the device half, torch on the CPU) and
  ``partition_ids_host`` (numpy) of ``HashPartitioning``,
  ``RoundRobinPartitioning``, ``SinglePartitioning`` and
  ``RangePartitioning`` equal the reference's device (jnp) and host
  halves bit for bit, over int32, int64, float32, float64 (-0.0, NaN,
  subnormals, infinities), date and string keys (multibyte UTF-8, empty)
  with NULLs and a dead tail; range bounds are picked by both packages'
  ``compute_bounds`` from the same sample and must agree first.
  ``split_batch`` and ``split_host_batch`` give the reference's pieces.
- ``ShuffleExchangeExec`` at 1, 3 and 8 partitions: each output
  partition holds the reference's rows (as a multiset), on both engines,
  through a filtered (selection-vector) child in several batches; the
  device half serves every row once and each piece carries its exact
  count. With a small ``aqe.coalescePartitions.targetRows`` the port's
  coalesced groups equal the reference's.
- ``Murmur3Hash``, ``Remainder`` and ``Pmod`` on edge values
  (``INT_MIN % -1`` for int32 and int64, zero divisors, NaN, infinities,
  subnormals) equal the reference's on both engines.

The reference runs its exchanges at the partition counts each test pins
(``spark.rapids.sql.shuffle.partitions`` plays no part below the
planner).
"""

from collections import Counter

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu import config as JC
from spark_rapids_tpu import exprs as JE
from spark_rapids_tpu.columnar import batch as jbatch
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar import host as jhost
from spark_rapids_tpu.ops import base as jbase
from spark_rapids_tpu.ops import basic as jbasic
from spark_rapids_tpu.ops.sort import SortOrder as JSortOrder
from spark_rapids_tpu.parallel import exchange as jex
from spark_rapids_tpu.parallel import partitioning as jpart

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import exprs as TE
from spark_rapids_tpu_torch import ops as TO
from spark_rapids_tpu_torch.columnar import batch as tbatch
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar import host as thost
from spark_rapids_tpu_torch.ops.base import ExecContext
from spark_rapids_tpu_torch.ops.sort import SortOrder as TSortOrder
from spark_rapids_tpu_torch.parallel import exchange as tex
from spark_rapids_tpu_torch.parallel import partitioning as tpart

CAP, LIVE = 48, 41


def _values(kind: str, rng):
    """LIVE python values of one key type (None is NULL)."""
    if kind == "int32":
        pool = [0, 1, -1, 7, 2 ** 31 - 1, -2 ** 31, 123456, -99]
    elif kind == "int64":
        pool = [0, 1, -1, 2 ** 63 - 1, -2 ** 63, 2 ** 40 + 3, -77, 5]
    elif kind in ("float32", "float64"):
        pool = [0.0, -0.0, float("nan"), float("inf"), -float("inf"), 1.5,
                -2.25, 1e-310 if kind == "float64" else 1e-40, -1e-310
                if kind == "float64" else -1e-40, 3.0e38]
    elif kind == "date":
        pool = [0, 1, -1, 9131, 10957, -25567, 2932896]
    else:
        pool = ["", "a", "héllo", "日本語", "spark", "sparks", "a" * 19,
                "Z"]
    vals = [pool[i] for i in rng.integers(0, len(pool), LIVE)]
    return [None if rng.random() < 0.15 else v for v in vals]


KINDS = ("int32", "int64", "float32", "float64", "date", "string")


def _batches(kind: str, seed: int = 0, sel: bool = False):
    """(JAX device batch, port device batch, JAX host batch, port host
    batch) of one key column and an int64 row id, CAP slots, LIVE live;
    with ``sel`` a selection vector drops every third row."""
    rng = np.random.default_rng(seed)
    vals = _values(kind, rng)
    rid = list(range(LIVE))
    jt, tt = jdt.type_named(kind), tdt.type_named(kind)
    jh = jhost.HostBatch(("k", "r"), [
        jhost.HostColumn.from_values(jt, vals),
        jhost.HostColumn.from_values(jdt.INT64, rid)])
    th = thost.HostBatch(("k", "r"), [
        thost.HostColumn.from_values(tt, vals),
        thost.HostColumn.from_values(tdt.INT64, rid)])
    jd = jhost.host_to_device(jh, capacity=CAP)
    td = thost.host_to_device(th, capacity=CAP, device="cpu")
    if sel:
        keep = np.arange(CAP) % 3 != 2
        jd = jd.with_sel(jnp.asarray(keep))
        td = td.with_sel(torch.from_numpy(keep))
    return jd, td, jh, th


def _partitionings(kind: str, n: int, jh, th):
    """(reference, port) partitionings of one kind over the key column;
    range bounds from each package's ``compute_bounds`` over the same
    sample (which must agree)."""
    jk = JE.BoundReference(0, jdt.type_named(kind_of(jh)))
    tk = TE.BoundReference(0, tdt.type_named(kind_of(jh)))
    if kind == "hash":
        return jpart.HashPartitioning([jk], n), \
            tpart.HashPartitioning([tk], n)
    if kind == "roundrobin":
        return jpart.RoundRobinPartitioning(n), \
            tpart.RoundRobinPartitioning(n)
    if kind == "single":
        return jpart.SinglePartitioning(), tpart.SinglePartitioning()
    jorders = [JSortOrder(jk, False, False)]
    torders = [TSortOrder(tk, False, False)]
    jsample = jhost.HostBatch(("k0",), [jh.columns[0]])
    tsample = thost.HostBatch(("k0",), [th.columns[0]])
    jb = jpart.RangePartitioning.compute_bounds(jsample, jorders, n)
    tb = tpart.RangePartitioning.compute_bounds(tsample, torders, n)
    assert tb.to_pylist() == jb.to_pylist() or _same_nan(
        tb.to_pylist(), jb.to_pylist())
    return jpart.RangePartitioning(jorders, n, jb), \
        tpart.RangePartitioning(torders, n, tb)


def kind_of(jh) -> str:
    return jh.columns[0].dtype.name


def _same_nan(a, b):
    return repr(a) == repr(b)


PARTITIONINGS = ("hash", "roundrobin", "single", "range")


@pytest.mark.parametrize("part", PARTITIONINGS)
@pytest.mark.parametrize("kind", KINDS)
def test_partition_ids_match_reference_on_both_engines(kind, part):
    n = 7
    jd, td, jh, th = _batches(kind, seed=KINDS.index(kind))
    jp, tp = _partitionings(part, n, jh, th)
    live = np.arange(CAP) < LIVE
    want = np.asarray(jp.partition_ids(jd))
    got = tp.partition_ids(td).numpy()
    np.testing.assert_array_equal(got[live], want[live])
    assert got.dtype == np.int32
    want_h = jp.partition_ids_host(jh)
    got_h = tp.partition_ids_host(th)
    np.testing.assert_array_equal(got_h, want_h)
    assert ((got_h >= 0) & (got_h < n)).all()
    if part in ("hash", "range", "roundrobin"):
        assert len(set(got_h.tolist())) > 1


def test_range_string_keys_of_unequal_widths():
    """Rows wider than the bounds: the port pads each key to one width
    first, so "abcde" goes above the bound "abcd" on both engines. (The
    reference zips its rows' two words against the bound's one and keeps
    "abcde" in partition 0 on both of its engines: ROADMAP queue C.)"""
    vals = ["abcd", "abcde", "abc", "b"]
    th = thost.HostBatch(("k",), [thost.HostColumn.from_values(
        tdt.STRING, vals)])
    bounds = thost.HostBatch(("k0",), [thost.HostColumn.from_values(
        tdt.STRING, ["abcd"])])
    part = tpart.RangePartitioning(
        [TSortOrder(TE.BoundReference(0, tdt.STRING))], 2, bounds)
    td = thost.host_to_device(th, capacity=8, device="cpu")
    want = [0, 1, 0, 1]
    assert part.partition_ids(td).numpy()[:4].tolist() == want
    assert part.partition_ids_host(th).tolist() == want


def _rows(hb):
    return Counter(repr(r) for r in hb.to_pylist())


@pytest.mark.parametrize("kind", ("int64", "string", "float64"))
def test_split_matches_reference(kind):
    jd, td, jh, th = _batches(kind, seed=3, sel=True)
    n = 5
    jp, tp = _partitionings("hash", n, jh, th)
    jpieces = jpart.split_batch(jd, jp.partition_ids(jd), n)
    tpieces = tpart.split_batch(td, tp.partition_ids(td), n)
    for jpc, tpc in zip(jpieces, tpieces):
        assert repr(thost.device_to_host(tpc).to_pylist()) == \
            repr(jhost.device_to_host(jpc).to_pylist())
    jhp = jpart.split_host_batch(jh, jp.partition_ids_host(jh), n)
    thp = tpart.split_host_batch(th, tp.partition_ids_host(th), n)
    assert repr([p.to_pylist() for p in thp]) == \
        repr([p.to_pylist() for p in jhp])
    assert sum(p.num_rows for p in thp) == LIVE


# ---------------------------------------------------------------------------
# ShuffleExchangeExec
# ---------------------------------------------------------------------------

SCHEMA = (("k", "int64"), ("s", "string"), ("f", "float64"), ("v", "int32"))


def _source_parts(seed: int):
    """Three partitions of 1-3 batches: an int64 key with duplicates and
    NULLs, strings, floats, and a value the filter reads."""
    rng = np.random.default_rng(seed)
    parts = []
    for p in range(3):
        batches = []
        for _ in range(p + 1):
            n = int(rng.integers(5, 40))
            batches.append({
                "k": [None if rng.random() < 0.1 else int(x)
                      for x in rng.integers(0, 25, n)],
                "s": [["", "x", "yy", "héllo", "zzzz"][i]
                      for i in rng.integers(0, 5, n)],
                "f": [[0.0, -0.0, float("nan"), 2.5, -1e300][i]
                      for i in rng.integers(0, 5, n)],
                "v": rng.integers(0, 10, n).tolist()})
        parts.append(batches)
    return parts


def _exchange(M, O, P, X, D, Src, parts, part: str, n: int, **kw):
    schema = tuple((nm, D.type_named(t)) for nm, t in SCHEMA)
    HB = (jhost if M is JE else thost).HostBatch
    src = Src(schema, [[HB.from_pydict(schema, b) for b in p]
                       for p in parts], **kw)
    R = M.BoundReference
    child = O.FilterExec(src, M.Not(M.EqualTo(R(3, D.INT32), M.lit(4))))
    keys = [R(0, D.INT64), R(1, D.STRING)]
    if part == "hash":
        p = P.HashPartitioning(keys, n)
    elif part == "roundrobin":
        p = P.RoundRobinPartitioning(n)
    elif part == "single":
        p = P.SinglePartitioning()
    else:
        SO = JSortOrder if M is JE else TSortOrder
        p = P.RangePartitioning([SO(R(2, D.FLOAT64), True, False),
                                 SO(keys[0], False, True)], n)
    return X.ShuffleExchangeExec(child, p, allow_coalesce=False)


def _jax_exchange(parts, part, n):
    return _exchange(JE, jbasic, jpart, jex, jdt, jbase.InMemorySourceExec,
                     parts, part, n)


def _port_exchange(parts, part, n):
    return _exchange(TE, TO, tpart, tex, tdt, TO.InMemorySourceExec, parts,
                     part, n, device="cpu")


def _partition_rows(ex, ctx, device: bool, download):
    out = []
    for p in range(ex.num_partitions(ctx)):
        if device:
            batches = list(ex.execute_device(ctx, p))
            rows = [r for hb in download(batches) for r in hb.to_pylist()]
        else:
            rows = [r for hb in ex.execute_host(ctx, p)
                    for r in hb.to_pylist()]
        out.append(Counter(repr(r) for r in rows))
    return out


@pytest.fixture(scope="module")
def exchange_parts():
    return _source_parts(seed=11)


@pytest.mark.parametrize("part,n", [(p, n) for p in ("hash", "roundrobin",
                                                    "range")
                                     for n in (1, 3, 8)] + [("single", 1)])
def test_exchange_partitions_match_reference(part, n, exchange_parts):
    jx = _jax_exchange(exchange_parts, part, n)
    tx = _port_exchange(exchange_parts, part, n)
    want = _partition_rows(jx, jbase.ExecContext(), False,
                           jhost.download_batches)
    assert _partition_rows(tx, ExecContext(), False, None) == want
    if part == "roundrobin" and n > 1:
        # Round robin numbers capacity slots on the device and rows on
        # the host, in both packages: the device halves are compared.
        want = _partition_rows(jx, jbase.ExecContext(), True,
                               jhost.download_batches)
    ctx = ExecContext()
    assert _partition_rows(tx, ctx, True, thost.download_batches) == want
    total = sum(sum(c.values()) for c in want)
    assert total == sum(1 for p in exchange_parts for b in p
                        for v in b["v"] if v != 4)
    # Each served piece's hint is its exact live count.
    for p in range(tx.num_partitions(ctx)):
        for b in tx.execute_device(ctx, p):
            assert b.rows_hint == int(b.live_count())
    if n > 1 and part != "single":
        assert sum(1 for c in want if c) > 1


def test_exchange_device_matches_reference_device(exchange_parts):
    """The reference's device materialization (its jitted pid count,
    pid-stable sort and slices) against the port's, partition by
    partition, in order."""
    jx = _jax_exchange(exchange_parts, "hash", 3)
    tx = _port_exchange(exchange_parts, "hash", 3)
    jctx = jbase.ExecContext()
    ctx = ExecContext()
    for p in range(3):
        want = [r for hb in jhost.download_batches(
            list(jx.execute_device(jctx, p))) for r in hb.to_pylist()]
        got = [r for hb in thost.download_batches(
            list(tx.execute_device(ctx, p))) for r in hb.to_pylist()]
        assert repr(got) == repr(want)


def test_aqe_groups_match_reference(exchange_parts):
    """Adjacent undersized partitions merge up to the row target."""
    raw = {"spark.rapids.sql.aqe.coalescePartitions.targetRows": 20}
    jx = _jax_exchange(exchange_parts, "hash", 8)
    tx = _port_exchange(exchange_parts, "hash", 8)
    jx.allow_coalesce = tx.allow_coalesce = True
    jctx = jbase.ExecContext(JC.TpuConf(raw))
    jctx.cache["engine"] = "device"
    ctx = ExecContext(C.TpuConf(raw))
    ctx.cache["engine"] = "device"
    want = jx._groups(jctx)
    assert tx._groups(ctx) == want
    assert 1 < len(want) < 8
    rows = [r for p in range(tx.num_partitions(ctx)) for hb in
            thost.download_batches(list(tx.execute_device(ctx, p)))
            for r in hb.to_pylist()]
    host = [r for p in range(8) for hb in tx.execute_host(ExecContext(), p)
            for r in hb.to_pylist()]
    assert Counter(map(repr, rows)) == Counter(map(repr, host))
    # Off the device engine (the host half) nothing coalesces.
    assert tx.num_partitions(ExecContext(C.TpuConf(raw))) == 8


def test_k1_sorts_the_partition_ids(exchange_parts, monkeypatch):
    """The map side's pid-stable sort is one ``native.stable_argsort_u32``
    call (kernel K1 on the card) per split batch."""
    from spark_rapids_tpu_torch.ops import native
    calls = []
    real = native.stable_argsort_u32

    def spy(keys, perm=None):
        calls.append(keys.numel())
        return real(keys, perm)
    monkeypatch.setattr(native, "stable_argsort_u32", spy)
    tx = _port_exchange(exchange_parts, "hash", 3)
    list(tx.execute_device(ExecContext(), 0))
    assert len(calls) == 6      # one per child batch
    calls.clear()
    tx = _port_exchange(exchange_parts, "hash", 1)
    list(tx.execute_device(ExecContext(), 0))
    assert not calls            # one destination: no sort


# ---------------------------------------------------------------------------
# Murmur3Hash, Remainder and Pmod
# ---------------------------------------------------------------------------

_INT32 = [0, 5, -7, 2 ** 31 - 1, -2 ** 31, -2 ** 31, 7, -1, 3, 100, 9, -9]
_DIV32 = [3, -3, 2, -1, -1, 1, 0, 5, -2, 7, 9, 4]
_F64 = [5.5, -5.5, 1e-310, -0.0, float("nan"), float("inf"),
        -float("inf"), 7.0, 2.5, 1e308, 0.0, -3.0]
_DF64 = [2.0, 2.0, 3.0, 1.0, 1.0, 3.0, 2.0, 0.0, -0.0, 1e-310, float("nan"),
         float("inf")]
ARITH = {
    "int32": (_INT32, _DIV32),
    "int64": ([v if abs(v) < 2 ** 31 - 1 else v * 2 ** 32 for v in _INT32],
              _DIV32),
    "float64": (_F64, _DF64),
}


def _pair_batches(kind: str):
    a, b = ARITH[kind]
    n = len(a)
    valid = np.ones(n, bool)
    valid[-1] = False
    cols = []
    for vals in (a, b):
        d = np.array(vals, dtype=np.dtype(kind))
        cols.append((np.where(valid, d, np.zeros(1, d.dtype)), valid))
    jt, tt = jdt.type_named(kind), tdt.type_named(kind)
    jd = jbatch.DeviceBatch(tuple(jbatch.DeviceColumn(
        jt, jnp.asarray(d), jnp.asarray(v)) for d, v in cols),
        jnp.asarray(n, jnp.int32))
    td = tbatch.DeviceBatch(tuple(tbatch.DeviceColumn(
        tt, torch.from_numpy(d.copy()), torch.from_numpy(v.copy()))
        for d, v in cols), torch.tensor(n, dtype=torch.int32))
    jh = jhost.HostBatch(("a", "b"), [jhost.HostColumn(jt, d, v)
                                      for d, v in cols])
    th = thost.HostBatch(("a", "b"), [thost.HostColumn(tt, d, v)
                                      for d, v in cols])
    return jd, td, jh, th


def _same(got_data, got_valid, want_data, want_valid):
    """Equal validity, equal data where valid (NaN equals NaN)."""
    got_valid, want_valid = np.asarray(got_valid), np.asarray(want_valid)
    np.testing.assert_array_equal(got_valid, want_valid)
    g = np.asarray(got_data)[want_valid]
    w = np.asarray(want_data)[want_valid]
    if g.dtype.kind == "f":
        nan = np.isnan(w)
        np.testing.assert_array_equal(np.isnan(g), nan)
        np.testing.assert_array_equal(g[~nan], w[~nan])
        np.testing.assert_array_equal(np.signbit(g[~nan]),
                                      np.signbit(w[~nan]))
    else:
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("op", ("Remainder", "Pmod"))
@pytest.mark.parametrize("kind", sorted(ARITH))
def test_remainder_and_pmod_match_reference(kind, op):
    jd, td, jh, th = _pair_batches(kind)
    jt, tt = jdt.type_named(kind), tdt.type_named(kind)
    je = getattr(JE, op)(JE.BoundReference(0, jt), JE.BoundReference(1, jt))
    te = getattr(TE, op)(TE.BoundReference(0, tt), TE.BoundReference(1, tt))
    jc, tc = je.eval(jd), te.eval(td)
    _same(tc.data.numpy(), tc.validity.numpy(), jc.data, jc.validity)
    jhc, thc = je.eval_host(jh), te.eval_host(th)
    _same(thc.data, thc.validity, jhc.data, jhc.validity)
    if kind != "float64":
        # INT_MIN % -1 (row 4) is 0, not a trap.
        assert tc.data[4].item() == 0 and thc.data[4] == 0


HASH_KINDS = ("int32", "int64", "float32", "float64", "date", "string",
              "bool")


@pytest.mark.parametrize("kind", HASH_KINDS)
def test_murmur3_hash_matches_reference(kind):
    rng = np.random.default_rng(5)
    if kind == "bool":
        vals = [None if rng.random() < 0.2 else bool(x)
                for x in rng.integers(0, 2, LIVE)]
    else:
        vals = _values(kind, rng)
    other = [int(x) for x in rng.integers(-1000, 1000, LIVE)]
    jt, tt = jdt.type_named(kind), tdt.type_named(kind)
    jh = jhost.HostBatch(("a", "b"), [
        jhost.HostColumn.from_values(jt, vals),
        jhost.HostColumn.from_values(jdt.INT64, other)])
    th = thost.HostBatch(("a", "b"), [
        thost.HostColumn.from_values(tt, vals),
        thost.HostColumn.from_values(tdt.INT64, other)])
    jd = jhost.host_to_device(jh, capacity=CAP)
    td = thost.host_to_device(th, capacity=CAP, device="cpu")
    je = JE.Murmur3Hash([JE.BoundReference(0, jt),
                         JE.BoundReference(1, jdt.INT64)])
    te = TE.Murmur3Hash([TE.BoundReference(0, tt),
                         TE.BoundReference(1, tdt.INT64)])
    jc, tc = je.eval(jd), te.eval(td)
    np.testing.assert_array_equal(tc.validity.numpy(),
                                  np.asarray(jc.validity))
    np.testing.assert_array_equal(tc.data.numpy()[:LIVE],
                                  np.asarray(jc.data)[:LIVE])
    jhc, thc = je.eval_host(jh), te.eval_host(th)
    np.testing.assert_array_equal(thc.data, jhc.data)
    np.testing.assert_array_equal(thc.validity, jhc.validity)
