"""Port parity: the broadcast hash join and its probe kernel K3.

- ``native.searchsorted_u64_pair`` on CPU tensors runs its plain version;
  it must be bit-identical to the JAX package's Pallas join probe run
  through the interpreter (``native.forced()``), over full-range u64
  fingerprints (keys at and above 2^63 included), runs of equal keys, a
  sentinel tail, and probes of 0, 2^64-1 and the sentinel.
- ``build_side`` must sort, fingerprint and summarize the build exactly as
  the JAX package's.
- ``BroadcastHashJoinExec`` must emit the JAX exec's rows in the same
  order for every join type on every probe path: dense (unique integral
  keys), fast (runs of at most 4), synced (longer runs) and the
  fingerprint-only paths of string and float keys, with null keys,
  NaN / -0.0 / subnormal float keys and a residual condition.
"""

import math
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu import exprs as JE
from spark_rapids_tpu.columnar import batch as jbatch
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar import host as jhost
from spark_rapids_tpu.ops import base as jbase
from spark_rapids_tpu.ops import basic as jbasic
from spark_rapids_tpu.ops import join as jjoin
from spark_rapids_tpu.ops import native as jnative

from spark_rapids_tpu_torch import exprs as TE
from spark_rapids_tpu_torch import ops as TO
from spark_rapids_tpu_torch.columnar import batch as tbatch
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar import host as thost
from spark_rapids_tpu_torch.ops import join as tjoin
from spark_rapids_tpu_torch.ops import native as tnative

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


# ---------------------------------------------------------------------------
# K3: the probe's two searches
# ---------------------------------------------------------------------------

def _probe_case(cap_b, cap_p, seed):
    """Sorted full-range u64 build fingerprints with runs up to 7 and a
    sentinel tail; probes hit runs, miss, and sit on the edges."""
    rng = np.random.default_rng(seed)
    n_live = int(rng.integers(0, cap_b + 1)) if cap_b > 8 else cap_b - 2
    distinct = rng.integers(0, 2 ** 64 - 1, max(n_live, 1), dtype=np.uint64,
                            endpoint=True)
    distinct[:2] = [np.uint64(2 ** 63), np.uint64(2 ** 63 - 1)]
    live = np.repeat(distinct, rng.integers(1, 8, len(distinct)))[:n_live]
    build = np.concatenate([np.sort(live),
                            np.full(cap_b - len(live), U64_MAX)])
    probe = np.concatenate([
        rng.choice(build, cap_p),
        rng.integers(0, 2 ** 64 - 1, cap_p, dtype=np.uint64, endpoint=True)])
    probe = rng.permutation(probe)[:cap_p]
    probe[:3] = [np.uint64(0), U64_MAX, np.uint64(2 ** 63)]
    return build, probe


@pytest.mark.parametrize("cap_b,cap_p", [(8, 8), (16, 24), (96, 12),
                                         (24, 96)])
def test_probe_plain_matches_pallas_kernel(cap_b, cap_p):
    build, probe = _probe_case(cap_b, cap_p, cap_b * 1000 + cap_p)
    with jnative.forced():
        jlo, jhi = jnative.searchsorted_u64_pair(jnp.asarray(build),
                                                 jnp.asarray(probe))
    tlo, thi = tnative.searchsorted_u64_pair(
        torch.from_numpy(build.view(np.int64)),
        torch.from_numpy(probe.view(np.int64)))
    assert tlo.dtype == torch.int32 and thi.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jlo), tlo.numpy())
    np.testing.assert_array_equal(np.asarray(jhi), thi.numpy())
    np.testing.assert_array_equal(np.searchsorted(build, probe, "left"),
                                  tlo.numpy())
    np.testing.assert_array_equal(np.searchsorted(build, probe, "right"),
                                  thi.numpy())


def test_probe_over_an_all_sentinel_build():
    build = np.full(12, U64_MAX)
    probe = np.array([0, 2 ** 63, 2 ** 64 - 1, 5], np.uint64)
    lo, hi = tnative.searchsorted_u64_pair(
        torch.from_numpy(build.view(np.int64)),
        torch.from_numpy(probe.view(np.int64)))
    assert lo.tolist() == [0, 0, 0, 0] and hi.tolist() == [0, 0, 12, 0]


def test_probe_wrapper_rejects_bad_input():
    """K3's entry checks its inputs once, dtype and layout before the
    device: the routing wrapper checks nothing of its own."""
    ok = torch.zeros(8, dtype=torch.int64)
    out = torch.zeros(8, dtype=torch.int32)
    for built, probe in ((ok.to(torch.int32), ok),
                         (ok, torch.zeros(16, dtype=torch.int64)[::2]),
                         (ok.view(2, 4), ok)):
        with pytest.raises(ValueError, match="contiguous 1-D int64"):
            tnative.join_probe(built, probe, out, out.clone())


def test_cpu_tensors_never_take_the_cuda_branch(monkeypatch):
    def boom(*args):
        raise AssertionError("CUDA branch taken for a CPU tensor")
    monkeypatch.setattr(tnative, "_searchsorted_u64_pair_cuda", boom)
    monkeypatch.setattr(tnative, "_stable_argsort_u32_cuda", boom)
    tnative.reset_counters()
    rows = _run_port(*_join_case("synced", 3), "inner", None)
    assert rows
    assert tnative.counters() == {"radix_sort": 0, "join_probe": 0,
                                  "seg_reduce": 0, "rle_decode": 0}


def test_cuda_kernel_entry_refuses_cpu_tensors():
    fp = torch.zeros(8, dtype=torch.int64)
    out = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tnative.join_probe(fp, fp, out, out.clone())


# ---------------------------------------------------------------------------
# build_side
# ---------------------------------------------------------------------------

def _col_pair(name, data, validity, lengths=None):
    jt, tt = jdt.type_named(name), tdt.type_named(name)
    j = jbatch.DeviceColumn(jt, jnp.asarray(data), jnp.asarray(validity),
                            None if lengths is None else jnp.asarray(lengths))
    t = tbatch.DeviceColumn(tt, torch.from_numpy(np.array(data)),
                            torch.from_numpy(np.array(validity)),
                            None if lengths is None
                            else torch.from_numpy(np.array(lengths)))
    return j, t


@pytest.mark.parametrize("kind", ["int_unique", "int_runs", "string",
                                  "float"])
def test_build_side_matches_reference(kind):
    rng = np.random.default_rng(len(kind))
    cap, live = 96, 83
    validity = (rng.random(cap) < 0.85) & (np.arange(cap) < live)
    cols = []
    if kind == "int_unique":
        k = rng.permutation(np.arange(-40, 56, dtype=np.int64))
        cols.append(("int64", k, None))
        cols.append(("int32", rng.integers(0, 3, cap).astype(np.int32),
                     None))
    elif kind == "int_runs":
        cols.append(("int64", rng.integers(-2 ** 62, 2 ** 62, 20)[
            rng.integers(0, 20, cap)], None))
    elif kind == "string":
        lens = rng.integers(0, 6, cap).astype(np.int32)
        s = rng.choice(np.frombuffer(b"xyz", np.uint8), (cap, 8))
        s[np.arange(8)[None, :] >= lens[:, None]] = 0
        cols.append(("string", s.astype(np.uint8), lens))
    else:
        cols.append(("float64", rng.choice(np.array(
            [np.nan, -0.0, 0.0, 1e-310, -1e-310, 2.5, -np.inf]), cap), None))
    jcols, tcols = [], []
    for name, data, lengths in cols:
        v = validity if kind != "int_unique" else np.ones(cap, bool)
        data = np.where(v if data.ndim == 1 else v[:, None], data,
                        np.zeros(1, data.dtype))
        if lengths is not None:
            lengths = np.where(v, lengths, 0).astype(np.int32)
        j, t = _col_pair(name, data, v, lengths)
        jcols.append(j)
        tcols.append(t)
    # A row-index payload makes the permutation visible.
    j, t = _col_pair("int64", np.arange(cap, dtype=np.int64),
                     np.ones(cap, bool))
    jcols.append(j)
    tcols.append(t)
    keys = list(range(len(cols)))
    jb = jbatch.DeviceBatch(tuple(jcols), jnp.asarray(live, jnp.int32))
    tb = tbatch.DeviceBatch(tuple(tcols), torch.tensor(live,
                                                       dtype=torch.int32))
    jbs = jjoin.build_side(jb, keys)
    tbs = tjoin.build_side(tb, keys)
    np.testing.assert_array_equal(
        np.asarray(jbs.fp).view(np.int64), tbs.fp.numpy())
    for jc, tc in zip(jbs.batch.columns, tbs.batch.columns):
        np.testing.assert_array_equal(np.asarray(jc.data), tc.data.numpy())
        np.testing.assert_array_equal(np.asarray(jc.validity),
                                      tc.validity.numpy())
    np.testing.assert_array_equal(np.asarray(jbs.matchable),
                                  tbs.matchable.numpy())
    assert jbs.stats_host() == tbs.stats_host()
    assert int(jbs.max_run) == tbs.stats_host()[0]
    if kind == "int_runs":
        assert tbs.stats_host()[0] > 1


# ---------------------------------------------------------------------------
# BroadcastHashJoinExec against the JAX exec
# ---------------------------------------------------------------------------

LEFT = (("lk", "int64"), ("ls", "string"), ("lf", "float64"),
        ("lv", "int32"))
RIGHT = (("rk", "int64"), ("rs", "string"), ("rf", "float64"),
         ("rv", "int32"), ("rd", "date"))

# Key columns per path: (left ordinals, right ordinals).
PATH_KEYS = {"dense": ([0], [0]), "dense2": ([0, 3], [0, 3]),
             "fast": ([0], [0]), "synced": ([0], [0]),
             "string": ([1], [1]), "float": ([2], [2])}


def _side(schema, n, keys, seed, build):
    """One side's python columns. ``keys`` names the join path; the build
    side's key distribution decides which path the probe takes."""
    rng = np.random.default_rng(seed)
    floats = [float("nan"), -0.0, 0.0, 1e-310, -1e-310, 1.5, -2.25]
    words = ["", "a", "bb", "abc", "zzzzzzzzz", "bba"]
    if keys in ("dense", "dense2") and build:
        k = rng.permutation(np.arange(3, 3 + n)).tolist()
    elif keys == "fast" and build:
        k = np.repeat(rng.permutation(np.arange(n)), 3)[:n].tolist()
        k = rng.permutation(k).tolist()
    elif keys == "string" and build:
        k = rng.integers(0, 10, n).tolist()
        words = [f"w{i}" * (i % 3 + 1) for i in range(n)]
        s = rng.permutation(np.repeat(np.arange(n), 2)[:n])
    else:
        k = rng.integers(0, n // 5 + 2, n).tolist()
    cols = {}
    for name, t in schema:
        if name[1] == "k":
            vals = k
        elif name[1] == "s":
            if keys == "string" and build:
                vals = [words[i] for i in s]
            elif keys == "string":
                vals = [f"w{i}" * (i % 3 + 1)
                        for i in rng.integers(0, n + 5, n)]
            else:
                vals = [words[i] for i in rng.integers(0, len(words), n)]
        elif name[1] == "f":
            vals = [floats[i] for i in rng.integers(0, len(floats), n)]
        elif name[1] == "v":
            vals = (np.arange(n) % 7).tolist() if keys == "dense2" \
                else rng.integers(-5, 5, n).tolist()
        else:
            vals = rng.integers(8_000, 9_000, n).tolist()
        null_rate = 0.0 if (keys in ("dense", "dense2") and build
                            and name[1] in "kv") else 0.12
        vals = [None if rng.random() < null_rate else v for v in vals]
        cols[name] = vals
    return cols


def _split(cols, sizes):
    out, lo = [], 0
    for sz in sizes:
        out.append({k: v[lo:lo + sz] for k, v in cols.items()})
        lo += sz
    return out


def _join_case(path, seed):
    """Build (right) side in 2 partitions, probe (left) side in 3
    partitions of 1-2 batches (one capacity throughout, so the JAX side
    compiles each program once)."""
    left = _side(LEFT, 144, path, seed, build=False)
    right = _side(RIGHT, 72, path, seed + 100, build=True)
    lparts = [_split(p, [24, 24]) if i == 0 else [p]
              for i, p in enumerate(_split(left, [48, 48, 48]))]
    rparts = [[p] for p in _split(right, [36, 36])]
    return path, lparts, rparts


def _tree(M, O, D, Src, path, lparts, rparts, join_type, cond, **src_kw):
    lschema = tuple((n, D.type_named(t)) for n, t in LEFT)
    rschema = tuple((n, D.type_named(t)) for n, t in RIGHT)
    HB = (jhost if M is JE else thost).HostBatch
    left = Src(lschema, [[HB.from_pydict(lschema, b) for b in p]
                         for p in lparts], **src_kw)
    right = Src(rschema, [[HB.from_pydict(rschema, b) for b in p]
                          for p in rparts], **src_kw)
    R = M.BoundReference
    # The build side's batches carry selection vectors.
    right = O.FilterExec(right, M.Not(M.EqualTo(R(3, D.INT32), M.lit(4))))
    lk, rk = PATH_KEYS[path]
    lkeys = [R(i, lschema[i][1]) for i in lk]
    rkeys = [R(i, rschema[i][1]) for i in rk]
    condition = None
    if cond:
        condition = M.GreaterThan(R(3, D.INT32), R(len(LEFT) + 3, D.INT32))
    J = jjoin if M is JE else tjoin
    return J.BroadcastHashJoinExec(left, right, lkeys, rkeys, join_type,
                                   condition)


def _norm(rows):
    """Rows with floats as bit patterns (NaNs as one token): -0.0 and 0.0
    differ, NaN equals NaN."""
    def v(x):
        if isinstance(x, float):
            return "nan" if math.isnan(x) else struct.pack("<d", x)
        return x
    return [tuple(v(x) for x in r) for r in rows]


def _run_jax(path, lparts, rparts, join_type, cond):
    plan = _tree(JE, jbasic, jdt, jbase.InMemorySourceExec, path, lparts,
                 rparts, join_type, cond)
    return plan.collect()


def _run_port(path, lparts, rparts, join_type, cond):
    plan = _tree(TE, TO, tdt, TO.InMemorySourceExec, path, lparts, rparts,
                 join_type, cond, device="cpu")
    return plan.collect()


JOINS = ["inner", "left", "right", "semi", "anti"]


@pytest.mark.parametrize("join_type", JOINS)
@pytest.mark.parametrize("path", ["dense", "dense2", "fast", "synced",
                                  "string", "float"])
def test_join_matches_reference(path, join_type):
    case = _join_case(path, seed=len(path) + JOINS.index(join_type))
    want = _run_jax(*case, join_type, False)
    got = _run_port(*case, join_type, False)
    assert _norm(got) == _norm(want)
    if join_type in ("inner", "semi"):
        assert got, "the case must produce matches"


@pytest.mark.parametrize("join_type", JOINS)
@pytest.mark.parametrize("path", ["dense", "synced"])
def test_join_with_condition_matches_reference(path, join_type):
    case = _join_case(path, seed=7)
    want = _run_jax(*case, join_type, True)
    got = _run_port(*case, join_type, True)
    assert _norm(got) == _norm(want)


def test_join_paths_taken():
    """Each case drives the path it is named for."""
    for path, want in (("dense", "dense"), ("dense2", "dense"),
                       ("fast", "fast"), ("synced", "synced"),
                       ("string", "fast"), ("float", "synced")):
        _, _, rparts = _join_case(path, seed=1)
        rschema = tuple((n, tdt.type_named(t)) for n, t in RIGHT)
        b = thost.host_to_device(thost.HostBatch.from_pydict(
            rschema, {k: sum((p[0][k] for p in rparts), [])
                      for k in rparts[0][0]}), device="cpu")
        built = tjoin.build_side(b, PATH_KEYS[path][1])
        mr = built.stats_host()[0]
        tjoin._maybe_build_dense(built)
        got = "dense" if built.table is not None else \
            "fast" if 0 < mr <= tjoin._FAST_PATH_MAX_RUN else "synced"
        assert got == want, (path, mr)


@pytest.mark.parametrize("join_type", JOINS)
def test_empty_build_side_matches_reference(join_type):
    path, lparts, rparts = _join_case("dense", seed=3)
    rparts = [[{k: [] for k in rparts[0][0]}]]
    want = _run_jax(path, lparts, rparts, join_type, False)
    got = _run_port(path, lparts, rparts, join_type, False)
    assert _norm(got) == _norm(want)


def test_full_outer_join_is_refused():
    """A full outer join over a broadcast build needs one probe partition
    (else its unmatched build rows would come out once a partition)."""
    src = TO.InMemorySourceExec((("k", tdt.INT64),), [[], []], device="cpu")
    join = tjoin.BroadcastHashJoinExec(src, src, [TE.BoundReference(
        0, tdt.INT64)], [TE.BoundReference(0, tdt.INT64)], "full")
    with pytest.raises(NotImplementedError, match="shuffled"):
        join.collect(TO.ExecContext())
