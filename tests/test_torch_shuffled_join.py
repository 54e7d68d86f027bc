"""Port parity: ``ShuffledHashJoinExec`` (full outer included) and
``BroadcastNestedLoopJoinExec`` against the JAX package on the CPU.

- A shuffled join over two hash exchanges at 1 and 4 partitions, for
  every join type (inner, left, right, full, semi, anti), on int64 keys
  with duplicate build keys (the synced probe path), unique keys (the
  dense table; a full outer join never takes it), string keys and float
  keys (NaN, -0.0, subnormals), NULL keys on both sides, with and
  without a residual condition, and with an empty build or probe side.
  The port's device half (torch on the CPU) gives the rows of the
  reference's host half as a multiset (the float keys without
  subnormals, which both device halves read as zero and both host
  halves by value), and the port's host half gives them in the
  reference's order (floats bit for bit); for a full outer join with a
  residual at four partitions the reference's device half is run too
  (its runtime re-plan off) and matched partition by partition. These
  run the port's re-plan off; with it on (the default) every join but
  the full outer one demotes to a broadcast join at four partitions in
  both packages, and the port's rows equal the reference's demoted
  device rows.
- The nested-loop join, for cross and for a condition under every join
  type, with an empty build side, against the reference the same way.
- The build rows a full outer join emits unmatched carry a NULL probe
  side, and a right or full nested-loop join over several probe
  partitions is refused, as the reference's asserts.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)
import math
import struct
from collections import Counter

import pytest

from spark_rapids_tpu import config as JC
from spark_rapids_tpu import exprs as JE
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar import host as jhost
from spark_rapids_tpu.ops import base as jbase
from spark_rapids_tpu.ops import basic as jbasic
from spark_rapids_tpu.ops import join as jjoin
from spark_rapids_tpu.parallel import exchange as jex
from spark_rapids_tpu.parallel import partitioning as jpart

from spark_rapids_tpu_torch import config as TC
from spark_rapids_tpu_torch import exprs as TE
from spark_rapids_tpu_torch import ops as TO
from spark_rapids_tpu_torch.columnar import dtypes as tdt
from spark_rapids_tpu_torch.columnar import host as thost
from spark_rapids_tpu_torch.ops import join as tjoin
from spark_rapids_tpu_torch.parallel import exchange as tex
from spark_rapids_tpu_torch.parallel import partitioning as tpart

from test_torch_join import LEFT, PATH_KEYS, RIGHT, _join_case

JOINS = ["inner", "left", "right", "full", "semi", "anti"]
NO_REPLAN = {"spark.rapids.sql.aqe.replan.enabled": False}
PATHS = ("synced", "dense", "string", "float")


def _norm(rows):
    """Rows with floats as bit patterns (NaNs as one token)."""
    def v(x):
        if isinstance(x, float):
            return "nan" if math.isnan(x) else struct.pack("<d", x)
        return x
    return [tuple(v(x) for x in r) for r in rows]


def _multiset(rows):
    return Counter(repr(r) for r in _norm(rows))


def _sources(M, O, D, Src, lparts, rparts, **kw):
    lschema = tuple((n, D.type_named(t)) for n, t in LEFT)
    rschema = tuple((n, D.type_named(t)) for n, t in RIGHT)
    HB = (jhost if M is JE else thost).HostBatch
    left = Src(lschema, [[HB.from_pydict(lschema, b) for b in p]
                         for p in lparts], **kw)
    right = Src(rschema, [[HB.from_pydict(rschema, b) for b in p]
                          for p in rparts], **kw)
    R = M.BoundReference
    # The build side's batches carry selection vectors.
    right = O.FilterExec(right, M.Not(M.EqualTo(R(3, D.INT32), M.lit(4))))
    return left, right, lschema, rschema


def _condition(M, D):
    R = M.BoundReference
    return M.GreaterThan(R(3, D.INT32), R(len(LEFT) + 3, D.INT32))


def _shuffled(M, O, D, Src, P, X, J, case, join_type, cond, n, **kw):
    path, lparts, rparts = case
    left, right, ls, rs = _sources(M, O, D, Src, lparts, rparts, **kw)
    R = M.BoundReference
    lk, rk = PATH_KEYS[path]
    lkeys = [R(i, ls[i][1]) for i in lk]
    rkeys = [R(i, rs[i][1]) for i in rk]
    return J.ShuffledHashJoinExec(
        X.ShuffleExchangeExec(left, P.HashPartitioning(lkeys, n)),
        X.ShuffleExchangeExec(right, P.HashPartitioning(rkeys, n)),
        lkeys, rkeys, join_type, _condition(M, D) if cond else None)


def _jax_shuffled(case, join_type, cond, n):
    return _shuffled(JE, jbasic, jdt, jbase.InMemorySourceExec, jpart, jex,
                     jjoin, case, join_type, cond, n)


def _port_shuffled(case, join_type, cond, n):
    return _shuffled(TE, TO, tdt, TO.InMemorySourceExec, tpart, tex, tjoin,
                     case, join_type, cond, n, device="cpu")


def _case(path, seed):
    return _join_case(path, seed=seed)


def _check(jplan, tplan):
    """The port's host half against the reference's in order, and its
    device half against the reference's host half as a multiset."""
    want = jplan.collect(device=False)
    got_host = tplan.collect(device=False)
    assert _norm(got_host) == _norm(want)
    # The shuffled join itself: the runtime re-plan, which may demote it
    # to a broadcast join, is off (test_demoted_join_matches_reference).
    got = tplan.collect(TO.ExecContext(TC.TpuConf(NO_REPLAN)))
    assert _multiset(got) == _multiset(want)
    return got


def _without_subnormals(case):
    """The case with its subnormal floats made normal: both device halves
    read a subnormal key as zero and both host halves by value, so the
    device-against-host comparison holds only without them."""
    path, lparts, rparts = case

    def normal(v):
        if isinstance(v, float) and v != 0.0 and abs(v) < 2.3e-308:
            return math.copysign(2.5, v)
        return v

    def fix(parts):
        return [[{k: [normal(v) for v in vals] for k, vals in b.items()}
                 for b in p] for p in parts]
    return path, fix(lparts), fix(rparts)


@pytest.mark.parametrize("n", (1, 4))
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("join_type", JOINS)
def test_shuffled_join_matches_reference(join_type, path, n):
    case = _without_subnormals(
        _case(path, seed=len(path) + JOINS.index(join_type)))
    got = _check(_jax_shuffled(case, join_type, False, n),
                 _port_shuffled(case, join_type, False, n))
    if join_type in ("inner", "semi", "full"):
        assert got, "the case must produce matches"


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("join_type", [j for j in JOINS if j != "full"])
def test_demoted_join_matches_reference(join_type, path):
    """At four partitions with the runtime re-plan on (the default) the
    small build side demotes the join to a broadcast join in both
    packages; the port's rows equal the reference's demoted device rows
    as a multiset. Over float keys they differ from the shuffled join's:
    -0.0 and 0.0 hash to different partitions there, so only the
    broadcast join pairs them (both packages)."""
    case = _without_subnormals(
        _case(path, seed=len(path) + JOINS.index(join_type)))
    jplan = _jax_shuffled(case, join_type, False, 4)
    tplan = _port_shuffled(case, join_type, False, 4)
    jctx = jbase.ExecContext(JC.TpuConf({}))
    want = jplan.collect(jctx, device=True)
    tctx = TO.ExecContext()
    got = tplan.run_batches(tctx)
    got = [r for hb in got for r in hb.to_pylist()]
    assert tctx.metrics["Cost@query"].values["joinDemotions"] == 1
    assert jctx.metrics["Cost@query"].values["joinDemotions"] == 1
    tctx.close()
    jctx.close()
    assert _multiset(got) == _multiset(want)


@pytest.mark.parametrize("n", (1, 4))
@pytest.mark.parametrize("join_type", JOINS)
def test_shuffled_join_with_condition_matches_reference(join_type, n):
    case = _case("synced", seed=7)
    _check(_jax_shuffled(case, join_type, True, n),
           _port_shuffled(case, join_type, True, n))


def test_shuffled_join_device_halves_agree():
    """The reference's device half against the port's, partition by
    partition (both exchanges split rows identically), for a full outer
    join with a residual condition at four partitions. The reference's
    runtime re-plan is not ported, so it is off."""
    case = _case("synced", seed=9)
    jplan = _jax_shuffled(case, "full", True, 4)
    tplan = _port_shuffled(case, "full", True, 4)
    jctx = jbase.ExecContext(JC.TpuConf(
        {"spark.rapids.sql.aqe.replan.enabled": False}))
    tctx = TO.ExecContext()
    total = 0
    for p in range(4):
        want = [r for hb in jhost.download_batches(
            list(jplan.execute_device(jctx, p))) for r in hb.to_pylist()]
        got = [r for hb in thost.download_batches(
            list(tplan.execute_device(tctx, p))) for r in hb.to_pylist()]
        assert _multiset(got) == _multiset(want), p
        total += len(got)
    assert total


@pytest.mark.parametrize("side", ("build", "probe"))
@pytest.mark.parametrize("join_type", JOINS)
def test_shuffled_join_with_an_empty_side(join_type, side):
    path, lparts, rparts = _case("synced", seed=3)
    if side == "build":
        rparts = [[{k: [] for k in rparts[0][0]}]]
    else:
        lparts = [[{k: [] for k in lparts[0][0]}]]
    case = (path, lparts, rparts)
    for n in (1, 4):
        _check(_jax_shuffled(case, join_type, False, n),
               _port_shuffled(case, join_type, False, n))


def test_full_outer_emits_unmatched_build_rows_once():
    """Each build row nothing matched comes out once, with NULL probe
    columns, whatever the partition count; the probe side's unmatched
    rows with NULL build columns."""
    case = _case("synced", seed=5)
    rows1 = _port_shuffled(case, "full", False, 1).collect()
    rows4 = _port_shuffled(case, "full", False, 4).collect()
    assert _multiset(rows1) == _multiset(rows4)
    nl = len(LEFT)
    build_only = [r for r in rows4 if all(v is None for v in r[:nl])]
    probe_only = [r for r in rows4 if all(v is None for v in r[nl:])]
    assert build_only and probe_only
    # A NULL-key build row never matches, so it is among the unmatched.
    assert any(r[nl] is None for r in build_only)


def test_broadcast_full_outer_needs_one_probe_partition():
    case = _case("synced", seed=5)
    path, lparts, rparts = case
    left, right, ls, rs = _sources(TE, TO, tdt, TO.InMemorySourceExec,
                                   lparts, rparts, device="cpu")
    R = TE.BoundReference
    join = tjoin.BroadcastHashJoinExec(left, right, [R(0, ls[0][1])],
                                       [R(0, rs[0][1])], "full")
    with pytest.raises(NotImplementedError, match="shuffled"):
        join.collect(TO.ExecContext())
    single = tjoin.BroadcastHashJoinExec(
        TO.CoalescePartitionsExec(left, 1), right, [R(0, ls[0][1])],
        [R(0, rs[0][1])], "full")
    shuffled = _port_shuffled(case, "full", False, 1)
    assert _multiset(single.collect()) == _multiset(shuffled.collect())


# ---------------------------------------------------------------------------
# The nested-loop join
# ---------------------------------------------------------------------------

NLJ = ["cross", "inner", "left", "right", "full", "semi", "anti"]


def _nested(M, O, D, Src, J, lparts, rparts, join_type, cond, **kw):
    left, right, _ls, _rs = _sources(M, O, D, Src, lparts, rparts, **kw)
    if join_type in ("right", "full"):
        left = O.CoalescePartitionsExec(left, 1)
    return J.BroadcastNestedLoopJoinExec(
        left, right, join_type, _condition(M, D) if cond else None)


def _small(seed, build_rows=None):
    """A small probe (left) side in 2 partitions and build (right) side
    in 2, so the cross product stays small."""
    from test_torch_join import _side, _split
    left = _side(LEFT, 24, "synced", seed, build=False)
    right = _side(RIGHT, 10 if build_rows is None else build_rows,
                  "synced", seed + 1, build=True)
    lparts = [[p] for p in _split(left, [12, 12])]
    n = len(right["rk"])
    rparts = [[p] for p in _split(right, [n // 2, n - n // 2])]
    return lparts, rparts


@pytest.mark.parametrize("cond", (False, True))
@pytest.mark.parametrize("join_type", NLJ)
def test_nested_loop_join_matches_reference(join_type, cond):
    lparts, rparts = _small(seed=NLJ.index(join_type) + 10 * cond)
    jplan = _nested(JE, jbasic, jdt, jbase.InMemorySourceExec, jjoin,
                    lparts, rparts, join_type, cond)
    tplan = _nested(TE, TO, tdt, TO.InMemorySourceExec, tjoin, lparts,
                    rparts, join_type, cond, device="cpu")
    got = _check(jplan, tplan)
    if join_type in ("cross", "inner"):
        assert len(got) > 24


@pytest.mark.parametrize("join_type", NLJ)
def test_nested_loop_join_with_an_empty_build(join_type):
    lparts, rparts = _small(seed=2, build_rows=0)
    rparts = [[{k: [] for k in rparts[0][0]}]]
    jplan = _nested(JE, jbasic, jdt, jbase.InMemorySourceExec, jjoin,
                    lparts, rparts, join_type, True)
    tplan = _nested(TE, TO, tdt, TO.InMemorySourceExec, tjoin, lparts,
                    rparts, join_type, True, device="cpu")
    _check(jplan, tplan)


def test_nested_loop_device_halves_agree():
    """The reference's device half of a conditional left nested-loop join
    against the port's, in order."""
    lparts, rparts = _small(seed=4)
    for jt, cond in (("left", True),):
        jplan = _nested(JE, jbasic, jdt, jbase.InMemorySourceExec, jjoin,
                        lparts, rparts, jt, cond)
        tplan = _nested(TE, TO, tdt, TO.InMemorySourceExec, tjoin, lparts,
                        rparts, jt, cond, device="cpu")
        assert _norm(tplan.collect()) == _norm(jplan.collect())


def test_right_nested_loop_needs_one_probe_partition():
    lparts, rparts = _small(seed=4)
    left, right, _ls, _rs = _sources(TE, TO, tdt, TO.InMemorySourceExec,
                                     lparts, rparts, device="cpu")
    for jt in ("right", "full"):
        with pytest.raises(NotImplementedError, match="single probe"):
            tjoin.BroadcastNestedLoopJoinExec(left, right, jt).collect(
                TO.ExecContext())
