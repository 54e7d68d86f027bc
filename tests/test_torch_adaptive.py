"""Port parity: the adaptive partial skip (``ops/aggregate.py``,
``spark.rapids.sql.agg.skipAggPassReductionRatio``) and the concurrent
stage materialization (``parallel/pipeline.py``
``prematerialize_stages``), against the JAX package on the CPU.

- A group-by over 4,096 rows in 4 partitions (numpy seed 3; a float
  column with NULLs) with count(*), count, sum, avg, min, max, first and
  last: on unique keys the first partial batch does not reduce (ratio
  1.0), so both packages skip the partial grouping of the later batches;
  on 7 keys (ratio 7/1,024) neither does. The decision equals the
  reference's device run's, and the rows equal its rows (integers
  exactly, floats within 1e-6 relative) and, but for first and last
  (arrival order after an exchange), the port's host engine's.
  At ratio 1.0 (off) nothing is decided and the rows are the same.
- A grouping-set plan (ROLLUP) never decides: its partial keeps its
  grouping.
- TPC-H q3 (the reference's ``tpch.generate`` at scale 0.003, 3 files a
  table, seed 7; auto-broadcast off, 4 partitions) materializes its three
  scan stages in one concurrent wave (``concurrentStages`` 3, at most
  ``maxConcurrentStages`` 2 at once), with rows equal to the pipeline-off
  run's, bit for bit.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)

import numpy as np
import pytest

from spark_rapids_tpu.api.dataframe import TpuSession as JSession
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.ops.aggregate import HashAggregateExec as JAgg
from spark_rapids_tpu.ops.base import ExecContext as JCtx
from spark_rapids_tpu.plan import logical as JL

from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.ops.aggregate import HashAggregateExec
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan import plan_cache as pc

from harness import assert_rows_equal

ROWS, PARTS = 4096, 4
SHAPE = {"spark.rapids.sql.variableFloatAgg.enabled": True,
         "spark.rapids.sql.shuffle.partitions": PARTS}
RATIO = "spark.rapids.sql.agg.skipAggPassReductionRatio"


@pytest.fixture(autouse=True)
def _fresh_cache():
    pc.cache().clear()
    yield
    pc.cache().clear()


def _data(unique: bool):
    rng = np.random.default_rng(3)
    k = np.arange(ROWS) if unique else np.arange(ROWS) % 7
    v = rng.uniform(-1e3, 1e3, ROWS)
    return {"k": [int(x) for x in k],
            "v": [None if i % 11 == 0 else float(x)
                  for i, x in enumerate(v)]}


def _query(session, D, M, unique: bool):
    df = session.create_dataframe(_data(unique), [("k", D.INT64),
                                                  ("v", D.FLOAT64)],
                                  num_partitions=PARTS)
    v = M.col("v")
    return df.group_by("k").agg(
        M.agg_count().alias("n"), M.agg_count(v).alias("nv"),
        M.agg_sum(v).alias("s"), M.agg_avg(v).alias("a"),
        M.agg_min(v).alias("lo"), M.agg_max(v).alias("hi"),
        M.agg_first(v).alias("f"), M.agg_last(v).alias("l"))


def _partials(root, cls):
    out = []

    def walk(op):
        if isinstance(op, cls) and op.mode == "partial":
            out.append(op)
        for c in op.children:
            walk(c)

    walk(root)
    return out


def _port(unique: bool, **over):
    """(rows, the partial's decision or None, the DataFrame)."""
    df = _query(TpuSession(dict(SHAPE, **over), device="cpu"), dt, L,
                unique)
    rows = df.collect()
    phys = df._physical()
    (partial,) = _partials(phys.root, HashAggregateExec)
    m = phys.last_ctx.metrics_for(partial).values
    decided = None if "partialSkip" not in m else bool(m["partialSkip"])
    return rows, decided, df


def _reference(unique: bool, **over):
    """(rows, the partial's decision or None) of the reference's device
    run, on a context of its own (which the reference leaves open)."""
    df = _query(JSession(dict(SHAPE, **over)), jdt, JL, unique)
    phys = df._physical()
    ctx = JCtx(phys.conf)
    rows = phys.collect(ctx)
    (partial,) = _partials(phys.root, JAgg)
    decided = ctx.cache.get(f"aggskip:{id(partial):x}")
    ctx.close()
    return rows, decided


@pytest.mark.parametrize("unique", [True, False])
def test_partial_skip_decision_and_rows_match_reference(unique):
    rows, decided, df = _port(unique)
    want, want_decided = _reference(unique)
    assert decided is want_decided is unique
    assert len(rows) == (ROWS if unique else 7)
    assert_rows_equal(sorted(rows), sorted(want), approx_float=True)
    # First/Last after an exchange pick by arrival order, which the host
    # engine does not share with the device: held to it without them.
    assert_rows_equal(sorted(r[:-2] for r in rows),
                      sorted(r[:-2] for r in df.collect_host()),
                      approx_float=True)


def test_partial_skip_off_at_ratio_one():
    rows, decided, _ = _port(True, **{RATIO: 1.0})
    assert decided is None
    want, _, _ = _port(True)
    assert_rows_equal(sorted(rows), sorted(want), approx_float=True)
    jrows, jdecided = _reference(True, **{RATIO: 1.0})
    assert jdecided is None
    assert_rows_equal(sorted(rows), sorted(jrows), approx_float=True)


def test_grouping_sets_keep_their_partial():
    s = TpuSession(dict(SHAPE), device="cpu")
    df = s.create_dataframe(_data(True), [("k", dt.INT64),
                                          ("v", dt.FLOAT64)],
                            num_partitions=PARTS)
    df = df.rollup("k").agg(L.agg_sum(L.col("v")).alias("s"))
    rows = df.collect()
    phys = df._physical()
    (partial,) = _partials(phys.root, HashAggregateExec)
    assert partial.allow_partial_skip is False
    assert "partialSkip" not in phys.last_ctx.metrics_for(partial).values
    assert len(rows) == ROWS + 1
    assert_rows_equal(sorted(rows, key=repr),
                      sorted(df.collect_host(), key=repr),
                      approx_float=True)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch_adaptive"))
    jtpch.generate(d, scale=0.003, files_per_table=3, seed=7)
    return d


def test_q3_stages_materialize_concurrently(data_dir):
    conf = dict(SHAPE, **{"spark.rapids.sql.autoBroadcastJoinThreshold": -1,
                          "spark.rapids.sql.format.scanCache.maxBytes": 0})
    df = tpch.QUERIES["q3"](TpuSession(conf, device="cpu"), data_dir)
    got = df.collect()
    pm = df.metrics()["Pipeline@query"]
    assert pm["concurrentStages"] == 3, pm
    serial = tpch.QUERIES["q3"](TpuSession(dict(conf, **{
        "spark.rapids.sql.pipeline.enabled": False}), device="cpu"),
        data_dir)
    want = serial.collect()
    assert got == want and got
    assert "concurrentStages" not in \
        serial.metrics().get("Pipeline@query", {})
    assert df._physical().last_ctx.last_leak_report == []
