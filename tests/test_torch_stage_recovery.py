"""Port parity: lineage-scoped recovery (``parallel/stages.py``), the
execution watchdog (``ops/base.py``) and the planner's recovery ladder
(``plan/planner.py``), as ``tests/test_stage_recovery.py`` pins the JAX
package's (all its classes but ``TestMeshDegrade``: the mesh exchange is
not ported).

- q3 (the reference's ``tpch.generate`` at scale 0.003, 3 files a table,
  seed 7; auto-broadcast off, 4 shuffle partitions) cuts into the
  reference's stage graph: the same stages, parents and member op names.
- ``stage_invalidate`` closes an exchange's kept pieces, and the next run
  on the same context recomputes only that stage.
- q3 under ``lostoutput@exchange.serve:1`` gives its fault-free rows bit
  for bit with one stage recompute, only one scan running twice; the
  reference's device path under the same schedule and seed gives the
  same rows (floats within 1e-6 relative) and the same
  ``stageRecomputes``. Stage recompute off falls back to the query retry;
  a repeated collect does not fire a consumed fault again.
- The watchdog kills an injected stall and the partition retry succeeds;
  an exhausted watchdog demotes to the query retry; a stall without the
  watchdog ends after its bounded nap and the retry recovers it.
- ``BroadcastExchangeExec``'s single is one catalog handle, served again
  without a rebuild, dropped by ``stage_invalidate``.
- The transient helpers equal the reference's: ``backoff_delay_ms`` for
  seeds 7 and 8 at attempts 0-5, ``is_transient_error`` on its markers,
  on a cancelled query and on a CUDA illegal-memory-access message (not
  transient); the retry budget exhausts and recovers as the reference's
  ``TestTransientRetry``.

Each test disarms both registries and restores their counters.
"""

import test_torch_threads  # noqa: F401  (one torch thread a core a worker)

import pytest

from spark_rapids_tpu import faults as jfaults
from spark_rapids_tpu.api.dataframe import TpuSession as JSession
from spark_rapids_tpu.benchmarks import tpch as jtpch
from spark_rapids_tpu.memory import oom as joom
from spark_rapids_tpu.parallel import stages as JS

from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch.api import TpuSession
from spark_rapids_tpu_torch.benchmarks import tpch
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.memory import oom
from spark_rapids_tpu_torch.ops.base import ExecContext, InMemorySourceExec
from spark_rapids_tpu_torch.parallel import stages as S
from spark_rapids_tpu_torch.parallel.exchange import BroadcastExchangeExec
from spark_rapids_tpu_torch.plan import plan_cache as pc
from spark_rapids_tpu_torch.plan.logical import agg_sum, col

from harness import assert_rows_equal

SHAPE = {"spark.rapids.sql.variableFloatAgg.enabled": True,
         "spark.rapids.sql.autoBroadcastJoinThreshold": -1,
         "spark.rapids.sql.shuffle.partitions": 4}


@pytest.fixture(autouse=True)
def _clean_fault_state():
    state, jstate = faults.snapshot(), jfaults.snapshot()
    faults.configure("")
    faults.reset_counters()
    jfaults.configure("")
    jfaults.reset_counters()
    oom.reset_degradation()
    yield
    faults.restore(state)
    jfaults.restore(jstate)
    oom.reset_degradation()
    pc.cache().clear()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch_stagerec"))
    jtpch.generate(d, scale=0.003, files_per_table=3, seed=7)
    return d


def _conf(chaos: str = "", **over) -> dict:
    conf = dict(SHAPE)
    conf["spark.rapids.sql.test.faults"] = chaos
    conf["spark.rapids.sql.test.faults.seed"] = 7
    conf["spark.rapids.sql.retry.backoffMs"] = 1
    # Scan counters reflect real (re-)execution.
    conf["spark.rapids.sql.format.scanCache.maxBytes"] = 0
    conf.update(over)
    return conf


def _session(chaos: str = "", **over) -> TpuSession:
    return TpuSession(_conf(chaos, **over), device="cpu")


def _jsession(chaos: str = "") -> JSession:
    return JSession(dict(_conf(chaos),
                         **{"spark.rapids.sql.cost.enabled": False}))


def _scan_batch_counts(df):
    """numOutputBatches per FileScanExec of the LAST collect, keyed by
    the scan's first file path."""
    from spark_rapids_tpu_torch.io.scan import FileScanExec
    phys = df._physical()
    ctx = phys.last_ctx
    out = {}

    def walk(op):
        if isinstance(op, FileScanExec):
            m = ctx.metrics.get(f"{op.name}@{id(op):x}")
            out[min(op.paths)] = \
                m.values.get("numOutputBatches", 0) if m else 0
        for c in op.children:
            walk(c)

    walk(phys.root)
    return out


def _shape(graph):
    return {sid: (st.parents, [type(o).__name__ for o in st.ops],
                  None if st.boundary is None
                  else type(st.boundary).__name__)
            for sid, st in graph.stages.items()}


# ---------------------------------------------------------------------------
# The stage DAG
# ---------------------------------------------------------------------------

class TestStageGraph:
    def _join_df(self, s):
        left = s.create_dataframe(
            {"k": [1, 2, 3, 4], "v": [10, 20, 30, 40]},
            [("k", dt.INT64), ("v", dt.INT64)])
        right = s.create_dataframe(
            {"k": [2, 3, 4, 5], "w": [200, 300, 400, 500]},
            [("k", dt.INT64), ("w", dt.INT64)])
        return left.join_on(right, ["k"], ["k"], strategy="shuffle")

    def test_two_exchange_join_builds_three_stages(self):
        phys = self._join_df(_session())._physical()
        g = S.build_stage_graph(phys.root)
        assert len(g) == 3
        result = g.stages[g.root_stage_id]
        assert result.boundary is None
        assert sorted(result.parents) == sorted(
            sid for sid in g.stages if sid != g.root_stage_id)
        for sid in result.parents:
            st = g.stages[sid]
            assert S.is_stage_boundary(st.boundary)
            assert g.stage_of_exchange(id(st.boundary)) is st

    def test_q3_stage_lineage_matches_reference(self, data_dir):
        phys = tpch.QUERIES["q3"](_session(), data_dir)._physical()
        g = S.build_stage_graph(phys.root)
        jphys = jtpch.QUERIES["q3"](_jsession(), data_dir)._physical()
        jg = JS.build_stage_graph(jphys.root)
        assert _shape(g) == _shape(jg)
        assert len(g) >= 6
        boundaries = [st.boundary for st in g.stages.values()
                      if st.boundary is not None]
        assert len({id(b) for b in boundaries}) == len(boundaries)
        children = {sid for st in g.stages.values() for sid in st.parents}
        assert children == set(g.stages) - {g.root_stage_id}

    def test_stage_invalidate_closes_buckets_and_recomputes(self):
        df = _session().create_dataframe(
            {"a": list(range(16))}, [("a", dt.INT64)],
            num_partitions=2).repartition(4, "a")
        phys = df._physical()
        g = S.build_stage_graph(phys.root)
        assert len(g) == 2
        ctx = ExecContext(phys.conf)
        rows1 = [r for hb in phys.root.run_batches(ctx)
                 for r in hb.to_pylist()]
        assert len(ctx.catalog.leak_report()) > 0
        (ex_stage,) = [st for st in g.stages.values()
                       if st.boundary is not None]
        src = ex_stage.boundary.children[0]
        batches1 = ctx.metrics_for(src).values["numOutputBatches"]
        S.invalidate_stage(ctx, ex_stage)
        assert ctx.catalog.leak_report() == []
        rows2 = [r for hb in phys.root.run_batches(ctx)
                 for r in hb.to_pylist()]
        assert sorted(rows2) == sorted(rows1) == [(a,) for a in range(16)]
        # The source ran once more: the stage was recomputed.
        assert ctx.metrics_for(src).values["numOutputBatches"] == \
            2 * batches1
        # A run with nothing invalidated serves the kept pieces.
        phys.root.run_batches(ctx)
        assert ctx.metrics_for(src).values["numOutputBatches"] == \
            2 * batches1
        ctx.close()
        assert ctx.last_leak_report == []


# ---------------------------------------------------------------------------
# lostoutput: recompute only the owning stage
# ---------------------------------------------------------------------------

class TestLostOutputRecovery:
    def test_q3_lostoutput_recomputes_only_lost_stage(self, data_dir):
        free_df = tpch.QUERIES["q3"](_session(), data_dir)
        free = free_df.collect()
        free_scans = _scan_batch_counts(free_df)
        df = tpch.QUERIES["q3"](
            _session("lostoutput@exchange.serve:1"), data_dir)
        got = df.collect()
        assert got == free and got
        rec = df.metrics()["Recovery@query"]
        assert rec.get("stageRecomputes") == 1, rec
        assert faults.counters().get("stageRecomputes") == 1
        fault_scans = _scan_batch_counts(df)
        assert set(fault_scans) == set(free_scans)
        doubled = [p for p in free_scans
                   if fault_scans[p] == 2 * free_scans[p]
                   and free_scans[p] > 0]
        untouched = [p for p in free_scans
                     if fault_scans[p] == free_scans[p]]
        assert len(doubled) == 1 and \
            len(untouched) == len(free_scans) - 1, \
            (free_scans, fault_scans)
        assert df._physical().last_ctx.last_leak_report == []
        # The reference's device path under the same schedule and seed.
        jdf = jtpch.QUERIES["q3"](
            _jsession("lostoutput@exchange.serve:1"), data_dir)
        want = jdf.collect()
        assert_rows_equal(got, want, approx_float=True, msg="q3")
        assert jdf.metrics()["Recovery@query"]["stageRecomputes"] == \
            rec["stageRecomputes"]

    def test_lostoutput_checksum_path_counts_in_metrics(self):
        s = _session("lostoutput@exchange.serve:1")
        data = {"k": [i % 3 for i in range(24)], "v": list(range(24))}
        schema = [("k", dt.INT64), ("v", dt.INT64)]
        df = s.create_dataframe(data, schema, num_partitions=2).group_by(
            "k").agg(agg_sum(col("v")).alias("s"))
        want = sorted(s.create_dataframe(data, schema).group_by("k").agg(
            agg_sum(col("v")).alias("s")).collect_host())
        assert sorted(df.collect()) == want
        rec = df.metrics()["Recovery@query"]
        assert rec.get("stageRecomputes") == 1, rec

    def test_lostoutput_falls_back_to_whole_query_when_disabled(self):
        s = _session("lostoutput@exchange.serve:1", **{
            "spark.rapids.sql.recovery.stageRecompute.enabled": False})
        df = s.create_dataframe(
            {"k": [1, 1, 2], "v": [1, 2, 3]},
            [("k", dt.INT64), ("v", dt.INT64)]).group_by("k").agg(
                agg_sum(col("v")).alias("s"))
        assert sorted(df.collect()) == [(1, 3), (2, 3)]
        c = faults.counters()
        # The loss carries the UNAVAILABLE marker: the query retry
        # recovered it, with no stage recompute.
        assert c.get("stageRecomputes", 0) == 0
        assert c.get("retriesAttempted", 0) >= 1

    def test_repeated_collect_after_recovery_no_refire(self):
        s = _session("lostoutput@exchange.serve:1")
        df = s.create_dataframe(
            {"k": [i % 4 for i in range(32)], "v": list(range(32))},
            [("k", dt.INT64), ("v", dt.INT64)],
            num_partitions=2).group_by("k").agg(
                agg_sum(col("v")).alias("s"))
        r1 = sorted(df.collect())
        assert faults.counters().get("stageRecomputes") == 1
        assert faults.counters().get("faultsInjected") == 1
        r2 = sorted(df.collect())
        assert r2 == r1
        assert faults.counters().get("faultsInjected") == 1
        assert faults.counters().get("stageRecomputes") == 1
        rec2 = df.metrics().get("Recovery@query", {})
        assert rec2.get("stageRecomputes", 0) == 0, rec2

    def test_repeated_collect_after_transient_recovery(self):
        s = _session("transient@download:1")
        df = s.create_dataframe({"a": [1, 2, 3]}, [("a", dt.INT64)])
        r1 = sorted(df.collect())
        assert r1 == [(1,), (2,), (3,)]
        assert faults.counters().get("faultsInjected") == 1
        assert sorted(df.collect()) == r1
        assert faults.counters().get("faultsInjected") == 1


# ---------------------------------------------------------------------------
# The execution watchdog
# ---------------------------------------------------------------------------

class TestWatchdog:
    def _wd_session(self, chaos, timeout_ms=1500, attempts=2):
        return _session(chaos, **{
            "spark.rapids.sql.watchdog.enabled": True,
            "spark.rapids.sql.watchdog.taskTimeoutMs": timeout_ms,
            "spark.rapids.sql.watchdog.maxAttempts": attempts})

    def test_stall_killed_and_partition_retry_succeeds(self):
        s = self._wd_session("stall@upload:1")
        df = s.create_dataframe({"a": [1, 2, 3]}, [("a", dt.INT64)])
        assert sorted(df.collect()) == [(1,), (2,), (3,)]
        c = faults.counters()
        assert c.get("watchdogKills", 0) >= 1, c
        assert c.get("partitionRetries", 0) >= 1, c
        rec = df.metrics()["Recovery@query"]
        assert rec.get("watchdogKills", 0) >= 1, rec

    def test_watchdog_exhausted_demotes_to_query_retry(self):
        # Both attempts stall -> DEADLINE_EXCEEDED -> the transient rung
        # re-runs the query, and the spent schedule lets it through.
        s = self._wd_session("stall@upload:2", timeout_ms=800)
        df = s.create_dataframe({"a": [7, 8]}, [("a", dt.INT64)])
        assert sorted(df.collect()) == [(7,), (8,)]
        c = faults.counters()
        assert c.get("watchdogKills", 0) >= 2, c
        assert c.get("retriesAttempted", 0) >= 1, c

    def test_stall_without_watchdog_is_bounded(self, monkeypatch):
        monkeypatch.setattr(faults, "STALL_TIMEOUT_S", 0.05)
        s = _session("stall@upload:1")
        df = s.create_dataframe({"a": [5]}, [("a", dt.INT64)])
        assert df.collect() == [(5,)]
        assert faults.counters().get("retriesAttempted", 0) >= 1

    @pytest.mark.parametrize("qname", ["q6", "q3"])
    def test_tpch_under_watchdog_stall_lostoutput(self, qname, data_dir):
        free = tpch.QUERIES[qname](_session(), data_dir).collect()
        s = self._wd_session(
            "stall@upload:1,lostoutput@exchange.serve:1",
            timeout_ms=2000, attempts=2)
        df = tpch.QUERIES[qname](s, data_dir)
        assert df.collect() == free
        c = faults.counters()
        assert c.get("faultsInjected", 0) >= 2, c
        assert c.get("watchdogKills", 0) >= 1, c
        assert c.get("stageRecomputes", 0) >= 1, c
        assert df._physical().last_ctx.last_leak_report == []


# ---------------------------------------------------------------------------
# Durable broadcast outputs
# ---------------------------------------------------------------------------

class TestBroadcastDurableOutput:
    def _bx(self):
        schema = (("a", dt.INT64),)
        hb = HostBatch.from_pydict(schema, {"a": [1, 2, 3]})
        return BroadcastExchangeExec(
            InMemorySourceExec(schema, [[hb]], device="cpu"))

    def test_device_single_is_catalog_registered(self):
        bx = self._bx()
        ctx = ExecContext()
        b = bx.collect_single_device(ctx)
        assert int(b.live_count()) == 3
        assert len(ctx.catalog.leak_report()) == 1
        # Served again: the SAME durable output, not a rebuild.
        b2 = bx.collect_single_device(ctx)
        assert len(ctx.catalog.leak_report()) == 1
        assert int(b2.live_count()) == 3
        assert ctx.metrics_for(bx.children[0]).values[
            "numOutputBatches"] == 1
        ctx.close()
        assert ctx.last_leak_report == []

    def test_host_single_matches_reference(self):
        from spark_rapids_tpu.columnar import dtypes as jdt
        from spark_rapids_tpu.columnar.host import HostBatch as JHB
        from spark_rapids_tpu.ops.base import ExecContext as JCtx
        from spark_rapids_tpu.ops.base import InMemorySourceExec as JSrc
        from spark_rapids_tpu.parallel.exchange import \
            BroadcastExchangeExec as JBx
        jschema = (("a", jdt.INT64),)
        jbx = JBx(JSrc(jschema, [[JHB.from_pydict(jschema, {"a": [1, 2]})],
                                 [JHB.from_pydict(jschema, {"a": [3]})]]))
        schema = (("a", dt.INT64),)
        bx = BroadcastExchangeExec(InMemorySourceExec(schema, [
            [HostBatch.from_pydict(schema, {"a": [1, 2]})],
            [HostBatch.from_pydict(schema, {"a": [3]})]], device="cpu"))
        ctx, jctx = ExecContext(), JCtx()
        assert bx.num_partitions(ctx) == jbx.num_partitions(jctx) == 1
        assert bx.collect_single_host(ctx).to_pylist() == \
            jbx.collect_single_host(jctx).to_pylist() == [(1,), (2,), (3,)]
        ctx.close()
        jctx.close()

    def test_stage_invalidate_drops_both_copies(self):
        bx = self._bx()
        ctx = ExecContext()
        bx.collect_single_device(ctx)
        bx.collect_single_host(ctx)
        assert S.is_stage_boundary(bx)
        bx.stage_invalidate(ctx)
        assert ctx.catalog.leak_report() == []
        assert bx._cache_key(True) not in ctx.cache
        assert bx._cache_key(False) not in ctx.cache
        # A later consumer rebuilds it.
        assert int(bx.collect_single_device(ctx).live_count()) == 3
        ctx.close()
        assert ctx.last_leak_report == []


# ---------------------------------------------------------------------------
# The transient retry: helpers and budget
# ---------------------------------------------------------------------------

class TestTransientRetry:
    @pytest.mark.parametrize("seed", [7, 8])
    def test_backoff_equals_reference(self, seed):
        got = [oom.backoff_delay_ms(i, 100, 2000, seed) for i in range(6)]
        assert got == [joom.backoff_delay_ms(i, 100, 2000, seed)
                       for i in range(6)]
        for i, x in enumerate(got):
            env = min(100 * 2 ** i, 2000)
            assert env * 0.5 <= x < env

    @pytest.mark.parametrize("err", [
        RuntimeError("UNAVAILABLE: socket gone"),
        RuntimeError("DEADLINE_EXCEEDED: slow"),
        ConnectionError("connection reset by peer"),
        OSError("Connection reset"), RuntimeError("Socket closed"),
        RuntimeError("ABORTED: x"), RuntimeError("failed to connect"),
        RuntimeError("stream terminated by RST_STREAM"),
        RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
        ValueError("bad input"),
        RuntimeError("CUDA error: an illegal memory access was "
                     "encountered"),
        RuntimeError("CUDA error: device-side assert triggered")])
    def test_is_transient_error_equals_reference(self, err):
        assert oom.is_transient_error(err) == joom.is_transient_error(err)

    def test_cuda_sticky_errors_and_cancel_are_not_transient(self):
        assert not oom.is_transient_error(RuntimeError(
            "CUDA error: an illegal memory access was encountered"))
        cancelled = faults.QueryCancelledError(3, "cancelled")
        jcancelled = jfaults.QueryCancelledError(3, "cancelled")
        assert not oom.is_transient_error(cancelled)
        assert oom.is_transient_error(cancelled) == \
            joom.is_transient_error(jcancelled)
        assert oom.is_transient_error(faults.InjectedTransientError("x"))
        assert oom.is_transient_error(faults.InjectedStallError("x"))

    def test_retry_budget_exhausts(self):
        s = _session("transient@download:9", **{
            "spark.rapids.sql.retry.transientMaxRetries": 2})
        df = s.create_dataframe({"a": [1, 2, 3]}, [("a", dt.INT64)])
        with pytest.raises(faults.InjectedTransientError):
            df.collect()
        assert faults.counters().get("retriesAttempted", 0) == 2

    def test_transient_recovers_within_budget(self):
        s = _session("transient@download:1")
        df = s.create_dataframe({"a": [1, 2, 3]}, [("a", dt.INT64)])
        assert sorted(df.collect()) == [(1,), (2,), (3,)]
        assert faults.counters().get("faultsInjected") == 1
        assert df.metrics()["Recovery@query"]["retriesAttempted"] == 1


# ---------------------------------------------------------------------------
# Fault-registry hygiene
# ---------------------------------------------------------------------------

class TestRegistryIsolation:
    def test_snapshot_restore_roundtrip(self):
        state = faults.snapshot()
        faults.configure("oom@somewhere:3", seed=11)
        faults.record("somethingOdd", 2)
        assert faults.injector() is not None
        faults.restore(state)
        assert faults.injector() is None
        assert "somethingOdd" not in faults.counters()

    def test_armed_schedule_does_not_leak(self):
        # The autouse fixture restores a clean registry before the next
        # test: test_snapshot_restore_roundtrip's disarmed assertion would
        # trip on a leak.
        faults.configure("transient@nowhere:5", seed=3)
        assert faults.injector() is not None
