"""Physical operator base (port of the JAX package's ``ops/base.py``).

A plan is a tree of ``Exec`` nodes; each node, per partition, produces an
iterator of ``DeviceBatch``es whose kernels are eager torch calls
(``execute_device``) or of ``HostBatch``es computed in numpy
(``execute_host``, the host engine). The planner picks one engine per
node and joins them with ``DeviceToHostExec`` / ``HostToDeviceExec``.
``Exec.collect`` runs every partition on the root's engine; on the device
it then downloads all result batches in one batched pass.

This slice keeps the core only: no pipeline, watchdog, scheduler, spill or
fault layers (later slices add them).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch import DeviceLike, resolve_device
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.columnar.host import (
    HostBatch, download_batches, host_to_device)
from spark_rapids_tpu_torch.config import TpuConf

Schema = Tuple[Tuple[str, DataType], ...]


class Metrics:
    """Per-operator metric registry (host-clock nanoseconds, counts)."""

    def __init__(self, owner: str = ""):
        self.owner = owner
        self.values: Dict[str, float] = {}

    def add(self, name: str, amount: float):
        self.values[name] = self.values.get(name, 0) + amount

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"Metrics({self.values})"


def record_batch(m: Metrics, batch: DeviceBatch) -> None:
    """Count one output batch, and its rows where they are known on the
    host (never forces a device sync)."""
    m.add("numOutputBatches", 1)
    if batch.rows_hint is not None:
        m.add("numOutputRows", int(batch.rows_hint))


@dataclasses.dataclass
class ExecContext:
    """Per-query execution context: conf, per-operator metrics, and a
    per-query cache (a broadcast join's built side, shared across its
    probe partitions)."""

    conf: TpuConf = dataclasses.field(default_factory=TpuConf)
    metrics: Dict[str, Metrics] = dataclasses.field(default_factory=dict)
    cache: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def metrics_for(self, op: "Exec") -> Metrics:
        key = f"{op.name}@{id(op):x}"
        m = self.metrics.get(key)
        if m is None:
            m = self.metrics[key] = Metrics(owner=op.name)
        return m


class timed:
    """Context manager adding elapsed host-clock ns to a metric. Kernels
    are asynchronous on the card, so on CUDA this measures dispatch, not
    device time."""

    def __init__(self, metrics: Metrics, name: str = "totalTime"):
        self.metrics = metrics
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.metrics.add(self.name, time.perf_counter_ns() - self.t0)
        return False


class Exec:
    """A physical operator. ``schema`` is the output schema."""

    def __init__(self, *children: "Exec"):
        self.children: Tuple["Exec", ...] = tuple(children)

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__

    def num_partitions(self, ctx: ExecContext) -> int:
        return self.children[0].num_partitions(ctx)

    def execute_device(self, ctx: ExecContext,
                       partition: int) -> Iterator[DeviceBatch]:
        raise NotImplementedError

    def execute_host(self, ctx: ExecContext,
                     partition: int) -> Iterator[HostBatch]:
        raise NotImplementedError

    def plan_device(self):
        """The device this plan's source uploads to."""
        dev = getattr(self, "device", None)
        if dev is not None:
            return dev
        for c in self.children:
            dev = c.plan_device()
            if dev is not None:
                return dev
        return None

    def collect(self, ctx: Optional[ExecContext] = None,
                device: bool = True) -> List[tuple]:
        """Run all partitions on the device engine, then download every
        result batch in one batched pass and return the rows; with
        ``device=False`` run them on the host engine."""
        ctx = ctx or ExecContext()
        # Adopt this query's wire codec (process-global,
        # spark.rapids.sql.wire.codec) before any upload happens.
        from spark_rapids_tpu_torch.columnar import wire
        wire.maybe_configure(ctx.conf)
        rows: List[tuple] = []
        if not device:
            for p in range(self.num_partitions(ctx)):
                for hb in self.execute_host(ctx, p):
                    rows.extend(hb.to_pylist())
            return rows
        batches: List[DeviceBatch] = []
        for p in range(self.num_partitions(ctx)):
            batches.extend(self.execute_device(ctx, p))
        names = tuple(n for n, _ in self.schema)
        for hb in download_batches(batches, names):
            rows.extend(hb.to_pylist())
        return rows


class LeafExec(Exec):
    """Base for source nodes."""

    def num_partitions(self, ctx: ExecContext) -> int:
        raise NotImplementedError


class InMemorySourceExec(LeafExec):
    """In-memory host-batch source, pre-partitioned; uploads each batch to
    ``device`` (``None`` = the CUDA card, raising when there is none)
    through the wire codec.

    The host batches never change and their staging bytes are a pure
    function of batch and codec mode, so each partition is encoded and
    packed once per mode and kept; every collect then only copies and
    decodes. Consecutive packed batches below
    ``spark.rapids.sql.wire.minUploadBytes`` share one copy. On the host
    engine it yields its host batches as they are."""

    def __init__(self, schema: Schema,
                 partitions: Sequence[Sequence[HostBatch]],
                 device: DeviceLike = None):
        super().__init__()
        self._schema = tuple(schema)
        self._partitions = [list(p) for p in partitions]
        self._packed: Dict[Tuple[str, int], list] = {}
        self.device = resolve_device(device)

    @property
    def schema(self) -> Schema:
        return self._schema

    def num_partitions(self, ctx: ExecContext) -> int:
        return len(self._partitions)

    def packed(self, partition: int) -> list:
        """The partition's ``EncodedBatch``es under the current codec
        mode, packed on first use."""
        from spark_rapids_tpu_torch.columnar import wire
        key = (wire.codec_mode(), partition)
        encs = self._packed.get(key)
        if encs is None:
            encs = self._packed[key] = [
                wire.pack_batch(hb) for hb in self._partitions[partition]]
        return encs

    def execute_device(self, ctx, partition):
        from spark_rapids_tpu_torch import config as C
        from spark_rapids_tpu_torch.columnar import wire
        m = ctx.metrics_for(self)
        with timed(m, "packTime"):
            encs = self.packed(partition)
        groups = wire.plan_upload_groups(
            [e.nbytes for e in encs],
            int(ctx.conf.get(C.WIRE_MIN_UPLOAD_BYTES)))
        for g in groups:
            with timed(m, "uploadTime"):
                outs = wire.upload_packed_group([encs[i] for i in g],
                                                self.device)
            for out in outs:
                record_batch(m, out)
                yield out

    def execute_host(self, ctx, partition):
        yield from iter(self._partitions[partition])


class DeviceToHostExec(Exec):
    """Device -> host transition (GpuColumnarToRowExec analog): runs the
    child on the device engine and downloads each partition's batches
    with one batched copy. Its metrics: ``deviceTime`` (the device
    subtree's dispatch), ``downloadTime`` (the copy, which waits for the
    device work), ``downloadRows`` and ``downloadBytes``."""

    def __init__(self, child: Exec):
        super().__init__(child)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute_host(self, ctx, partition):
        m = ctx.metrics_for(self)
        with timed(m, "deviceTime"):
            batches = list(self.children[0].execute_device(ctx, partition))
        moved: Dict[str, int] = {}
        with timed(m, "downloadTime"):
            hbs = download_batches(batches, tuple(n for n, _ in self.schema),
                                   moved)
        m.add("downloadRows", moved.get("rows", 0))
        m.add("downloadBytes", moved.get("bytes", 0))
        yield from hbs

    def execute_device(self, ctx, partition):  # pragma: no cover
        raise AssertionError("DeviceToHostExec is a host-side node")


class HostToDeviceExec(Exec):
    """Host -> device transition (GpuRowToColumnarExec analog): runs the
    child on the host engine and uploads each batch to ``device`` (None:
    the plan's source device) with the plain wire layout. ``hostTime``
    is the host clock spent pulling from the child: the host subtree,
    and any device subtree below it, whose share its
    ``DeviceToHostExec``s record."""

    def __init__(self, child: Exec, device: DeviceLike = None):
        super().__init__(child)
        self.device = None if device is None else resolve_device(device)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute_device(self, ctx, partition):
        m = ctx.metrics_for(self)
        dev = self.plan_device()
        it = self.children[0].execute_host(ctx, partition)
        while True:
            with timed(m, "hostTime"):
                hb = next(it, None)
            if hb is None:
                return
            with timed(m, "uploadTime"):
                out = host_to_device(hb, device=dev, mode="plain")
            record_batch(m, out)
            yield out

    def execute_host(self, ctx, partition):  # pragma: no cover
        raise AssertionError("HostToDeviceExec is a device-side node")
