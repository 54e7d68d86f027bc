"""Port parity: the runtime re-plan (``parallel/replan.py``), as
``tests/test_replan.py``'s ``TestRuntimeDemotion`` and ``TestReplanChaos``
pin the JAX package's.

A shuffled hash join whose build side MATERIALIZES small (the planner's
estimate keeps the filter's input size; the observed exchange is tiny)
demotes to a broadcast hash join mid-query. The same skew join (a
60,000-row probe, a 2,000-row dimension filtered to a few dozen rows,
``autoBroadcastJoinThreshold`` 20,000; numpy seed 5; 4 shuffle
partitions) runs through both packages:

- the static plan keeps the shuffled join; each case's decision,
  ``replanChecks``, ``joinDemotions`` and ``estimateErrorPct`` equal the
  reference's device run's, and the rows equal the reference's (floats
  within 1e-6 relative) and the port's host engine's;
- ``replanObservedBytes`` equals the reference's here, where every piece
  of the filtered dimension fits the smallest capacity; over a skewed
  batch (``test_observed_bytes_pinned_divergence``, one exchange run
  directly) they differ: the reference sums each piece at the capacity
  of its batch's largest piece, the port at its own rung, so the port's
  sum is the smaller, and both numbers are pinned;
- the probe exchange is never materialized and is flagged
  ``replan-skip:``; the delegate is a ``BroadcastHashJoinExec``;
- off by conf, or with the threshold at -1, nothing is checked; an
  observed size above the threshold keeps the shuffle;
- a lost build-side output under the re-plan recomputes one stage, the
  demotion still counted.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

from spark_rapids_tpu import faults as jfaults
from spark_rapids_tpu.api.dataframe import TpuSession as JSession
from spark_rapids_tpu.plan import logical as JL

from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.ops.base import ExecContext
from spark_rapids_tpu_torch.ops.join import (
    BroadcastHashJoinExec, ShuffledHashJoinExec)
from spark_rapids_tpu_torch.parallel import replan as RP
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan import plan_cache as pc

from harness import assert_rows_equal

# Cost placement off in both packages (the reference side always set it):
# the re-plan's Cost@query counters are checked alone.
BASE = {"spark.rapids.sql.variableFloatAgg.enabled": True,
        "spark.rapids.sql.autoBroadcastJoinThreshold": 20_000,
        "spark.rapids.sql.shuffle.partitions": 4,
        "spark.rapids.sql.cost.enabled": False}
# One exchange over a skewed batch (SKEW_ROWS int64 keys, SKEW_HOT of
# them equal) at 4 partitions: the kept pieces' device bytes, the port's
# and the reference transport's.
SKEW_ROWS, SKEW_HOT = 100, 90
PORT_OBSERVED = 1020
REF_OBSERVED = 2604


@pytest.fixture(autouse=True)
def _isolated():
    state, jstate = faults.snapshot(), jfaults.snapshot()
    faults.configure("")
    faults.reset_counters()
    yield
    faults.restore(state)
    jfaults.restore(jstate)
    pc.cache().clear()


@pytest.fixture(scope="module")
def pq_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("replan_pq")
    rng = np.random.default_rng(5)
    papq.write_table(pa.table({
        "k": rng.integers(0, 500, 60_000, dtype=np.int64),
        "v": rng.uniform(0, 1, 60_000),
    }), os.path.join(d, "big.parquet"))
    papq.write_table(pa.table({
        "dk": np.arange(2000, dtype=np.int64),
        "w": rng.uniform(0, 1, 2000),
        "flag": rng.integers(0, 100, 2000, dtype=np.int64),
    }), os.path.join(d, "dim.parquet"))
    return str(d)


def _conf(**over) -> dict:
    return dict(BASE, **over)


def _skew_join(session, pq_dir, M=L):
    big = session.read.parquet(os.path.join(pq_dir, "big.parquet"))
    dim = session.read.parquet(os.path.join(pq_dir, "dim.parquet")) \
        .filter(M.col("flag") == 3)
    return big.join_on(dim, ["k"], ["dk"]) \
        .group_by("k").agg(M.agg_sum(M.col("w")).alias("sw"))


def _port(pq_dir, **over):
    return _skew_join(TpuSession(_conf(**over), device="cpu"), pq_dir)


def _reference(pq_dir, **over):
    """The reference's device run: (rows, Cost@query)."""
    s = JSession(dict(_conf(**over),
                      **{"spark.rapids.sql.cost.enabled": False}))
    df = _skew_join(s, pq_dir, JL)
    rows = df.collect()
    return rows, dict(df.metrics().get("Cost@query", {}))


@pytest.fixture(scope="module")
def reference(pq_dir):
    jstate = jfaults.snapshot()
    jfaults.configure("")
    try:
        return {"default": _reference(pq_dir),
                "threshold64": _reference(pq_dir, **{
                    "spark.rapids.sql.autoBroadcastJoinThreshold": 64}),
                "off": _reference(pq_dir, **{
                    "spark.rapids.sql.aqe.replan.enabled": False})}
    finally:
        jfaults.restore(jstate)


def _find(root, cls):
    out = []

    def walk(n):
        if isinstance(n, cls):
            out.append(n)
        for c in n.children:
            walk(c)

    walk(root)
    return out


def _shuffled(root):
    return [j for j in _find(root, ShuffledHashJoinExec)
            if type(j) is ShuffledHashJoinExec]


def _decision_counters(m: dict) -> dict:
    return {k: m[k] for k in ("replanChecks", "joinDemotions",
                              "estimateErrorPct") if k in m}


class TestRuntimeDemotion:
    def test_statically_planned_as_shuffle(self, pq_dir):
        phys = _port(pq_dir)._physical()
        assert _shuffled(phys.root), \
            "estimate must keep the shuffled join statically"

    def test_demotes_and_matches_oracle(self, pq_dir, reference):
        df = _port(pq_dir)
        got = df.collect()
        m = df.metrics()["Cost@query"]
        assert m["joinDemotions"] == 1
        assert m["replanChecks"] == 1
        assert m["replanObservedBytes"] > 0
        want_rows, want_m = reference["default"]
        assert _decision_counters(m) == _decision_counters(want_m)
        assert got
        assert_rows_equal(sorted(got), sorted(want_rows), approx_float=True)
        assert_rows_equal(sorted(got), sorted(df.collect_host()),
                          approx_float=True)

    def test_observed_bytes_equal_reference(self, pq_dir, reference):
        df = _port(pq_dir)
        df.collect()
        got = df.metrics()["Cost@query"]["replanObservedBytes"]
        assert got == reference["default"][1]["replanObservedBytes"]

    def test_observed_bytes_pinned_divergence(self):
        from spark_rapids_tpu import exprs as JE
        from spark_rapids_tpu.columnar import dtypes as jdt
        from spark_rapids_tpu.columnar.host import HostBatch as JHB
        from spark_rapids_tpu.ops import base as jbase
        from spark_rapids_tpu.parallel import exchange as jex
        from spark_rapids_tpu.parallel import partitioning as jpart
        from spark_rapids_tpu_torch import exprs as TE
        from spark_rapids_tpu_torch.columnar import dtypes as tdt
        from spark_rapids_tpu_torch.columnar.host import HostBatch
        from spark_rapids_tpu_torch.ops.base import InMemorySourceExec
        from spark_rapids_tpu_torch.parallel import exchange as tex
        from spark_rapids_tpu_torch.parallel import partitioning as tpart
        keys = [7] * SKEW_HOT + list(range(SKEW_ROWS - SKEW_HOT))
        got = {}
        for name, E, D, HB, Src, X, P, Ctx, kw in (
                ("jax", JE, jdt, JHB, jbase.InMemorySourceExec, jex, jpart,
                 jbase.ExecContext, {}),
                ("port", TE, tdt, HostBatch, InMemorySourceExec, tex, tpart,
                 ExecContext, {"device": "cpu"})):
            schema = (("k", D.INT64),)
            src = Src(schema, [[HB.from_pydict(schema, {"k": keys})]], **kw)
            ex = X.ShuffleExchangeExec(src, P.HashPartitioning(
                [E.BoundReference(0, D.INT64)], 4))
            ctx = Ctx()
            ctx.cache["engine"] = "device"
            got[name] = ex.observed_total_bytes(ctx)
            ctx.close()
        assert (got["port"], got["jax"]) == (PORT_OBSERVED, REF_OBSERVED)
        assert got["port"] < got["jax"]

    def test_probe_shuffle_skipped(self, pq_dir):
        phys = _port(pq_dir)._physical()
        ctx = ExecContext(phys.conf)
        phys.install(ctx)           # the plan cache's literal bindings
        rows = phys.root.run_batches(ctx)
        assert rows
        join = _shuffled(phys.root)[0]
        build_ex, probe_ex = join.children[1], join.children[0]
        # The build exchange materialized; the probe exchange never did.
        assert build_ex._cache_key(True) in ctx.cache
        assert probe_ex._cache_key(True) not in ctx.cache
        assert ctx.cache.get(f"replan-skip:{id(probe_ex):x}")
        delegate = RP.demoted(ctx, join)
        assert isinstance(delegate, BroadcastHashJoinExec)
        assert delegate.children[0] is probe_ex.children[0]
        assert delegate.children[1] is build_ex
        assert ctx.metrics_for(probe_ex).values.get("materializeTime") \
            is None
        ctx.close()
        assert ctx.last_leak_report == []

    def test_disabled_by_conf(self, pq_dir, reference):
        df = _port(pq_dir, **{"spark.rapids.sql.aqe.replan.enabled": False})
        got = df.collect()
        assert "joinDemotions" not in df.metrics().get("Cost@query", {})
        assert "Cost@query" not in df.metrics()
        want_rows, want_m = reference["off"]
        assert want_m == {}
        assert_rows_equal(sorted(got), sorted(want_rows), approx_float=True)
        assert_rows_equal(sorted(got), sorted(_port(pq_dir).collect()),
                          approx_float=True)

    def test_threshold_minus_one_disables(self, pq_dir):
        df = _port(pq_dir, **{
            "spark.rapids.sql.autoBroadcastJoinThreshold": -1})
        df.collect()
        assert "joinDemotions" not in df.metrics().get("Cost@query", {})
        assert "replanChecks" not in df.metrics().get("Cost@query", {})

    def test_observed_above_threshold_keeps_shuffle(self, pq_dir,
                                                    reference):
        df = _port(pq_dir, **{
            "spark.rapids.sql.autoBroadcastJoinThreshold": 64})
        got = df.collect()
        m = df.metrics()["Cost@query"]
        assert m["replanChecks"] == 1
        assert "joinDemotions" not in m
        want_rows, want_m = reference["threshold64"]
        assert _decision_counters(m) == _decision_counters(want_m)
        assert_rows_equal(sorted(got), sorted(want_rows), approx_float=True)
        assert_rows_equal(sorted(got), sorted(df.collect_host()),
                          approx_float=True)


class TestReplanChaos:
    def test_lost_build_output_recomputes_one_stage(self, pq_dir):
        want = _port(pq_dir).collect()
        df = _port(pq_dir, **{
            "spark.rapids.sql.test.faults": "lostoutput@exchange.serve:1",
            "spark.rapids.sql.test.faults.seed": 7,
            "spark.rapids.sql.retry.backoffMs": 1})
        got = df.collect()
        assert got == want
        m = df.metrics()
        assert m["Recovery@query"]["stageRecomputes"] == 1
        assert m["Cost@query"]["joinDemotions"] >= 1
        assert df._physical().last_ctx.last_leak_report == []


class TestPortGuards:
    """The port's two guards on the re-plan, which the reference does not
    have (ROADMAP queue C): no candidate at one planned partition, and no
    demotion into a build the memory tier could not hold."""

    def test_one_partition_not_a_candidate(self, pq_dir):
        one = {"spark.rapids.sql.shuffle.partitions": 1}
        df = _port(pq_dir, **one)
        got = df.collect()
        assert "Cost@query" not in df.metrics()
        assert _shuffled(df._physical().root)
        # The reference demotes there (a pinned divergence); the rows agree.
        jstate = jfaults.snapshot()
        jfaults.configure("")
        try:
            want_rows, want_m = _reference(pq_dir, **one)
        finally:
            jfaults.restore(jstate)
        assert want_m["joinDemotions"] == 1
        assert_rows_equal(sorted(got), sorted(want_rows), approx_float=True)

    def test_build_above_budget_share_keeps_shuffle(self, pq_dir):
        want = _port(pq_dir, **{
            "spark.rapids.sql.aqe.replan.enabled": False}).collect()
        df = _port(pq_dir, **{
            "spark.rapids.sql.join.grace.buildFraction": 1e-9})
        got = df.collect()
        m = df.metrics()["Cost@query"]
        assert m["replanChecks"] == 1
        assert m["replanBudgetKeeps"] == 1
        assert "joinDemotions" not in m
        assert_rows_equal(sorted(got), sorted(want), approx_float=True)
        assert df._physical().last_ctx.last_leak_report == []

    @pytest.mark.parametrize("error", ["exhausted", "raw"])
    def test_build_oom_keeps_static_plan(self, pq_dir, monkeypatch, error):
        """An exhausted ladder, or an OOM no rung acted on (raised as
        torch raises it), while the re-plan materializes the build."""
        import torch
        from spark_rapids_tpu_torch.memory import oom
        from spark_rapids_tpu_torch.parallel.exchange import \
            ShuffleExchangeExec
        want = _port(pq_dir, **{
            "spark.rapids.sql.aqe.replan.enabled": False}).collect()
        calls = []

        def exhausted(self, ctx):
            calls.append(self)
            if error == "raw":
                raise torch.OutOfMemoryError("CUDA out of memory.")
            raise oom.OomRetryExhausted(
                RuntimeError("CUDA out of memory"), ["spill-some"])

        monkeypatch.setattr(ShuffleExchangeExec, "observed_total_bytes",
                            exhausted)
        df = _port(pq_dir)
        got = df.collect()
        assert len(calls) == 1
        m = df.metrics()["Cost@query"]
        assert m["replanChecks"] == 1
        assert m["replanOomKeeps"] == 1
        assert "joinDemotions" not in m
        assert "retriesAttempted" not in df.metrics().get(
            "Recovery@query", {})
        assert_rows_equal(sorted(got), sorted(want), approx_float=True)
        assert df._physical().last_ctx.last_leak_report == []

    def test_map_side_oom_retried_under_the_ladder(self, pq_dir,
                                                   monkeypatch):
        """A device OOM in the build exchange's partition ids (the map
        side's first device step of a window) is retried by the OOM
        ladder; the re-plan then demotes as without it."""
        import torch
        from spark_rapids_tpu_torch.parallel.partitioning import \
            HashPartitioning
        want = _port(pq_dir).collect()
        real = HashPartitioning.partition_ids
        calls = []

        def once(self, batch):
            calls.append(1)
            if len(calls) == 1:
                raise torch.OutOfMemoryError("CUDA out of memory.")
            return real(self, batch)

        monkeypatch.setattr(HashPartitioning, "partition_ids", once)
        df = _port(pq_dir)
        got = df.collect()
        m = df.metrics()
        assert m["Recovery@query"]["retriesAttempted"] >= 1
        assert m["Cost@query"]["joinDemotions"] == 1
        assert "replanOomKeeps" not in m["Cost@query"]
        assert_rows_equal(sorted(got), sorted(want), approx_float=True)
        assert df._physical().last_ctx.last_leak_report == []
