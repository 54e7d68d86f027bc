"""Physical operators of the port (see each module for its JAX
counterpart)."""

from spark_rapids_tpu_torch.ops.aggregate import (
    AggSpec, Average, Count, CountStar, First, HashAggregateExec, Last, Max,
    Min, Sum)
from spark_rapids_tpu_torch.ops.base import (
    DeviceToHostExec, Exec, ExecContext, HostToDeviceExec,
    InMemorySourceExec)
from spark_rapids_tpu_torch.ops.basic import (
    CoalescePartitionsExec, ExpandExec, FilterExec, GlobalLimitExec,
    LocalLimitExec, ProjectExec, RangeExec, UnionExec)
from spark_rapids_tpu_torch.ops.generate import GenerateExec
from spark_rapids_tpu_torch.ops.join import (
    BroadcastHashJoinExec, BroadcastNestedLoopJoinExec, ShuffledHashJoinExec)
from spark_rapids_tpu_torch.ops.pandas_exec import (
    AggregateInPandasExec, CoGroupedMapInPandasExec,
    FlatMapGroupsInPandasExec, MapInPandasExec)
from spark_rapids_tpu_torch.ops.sort import SortExec, SortOrder
from spark_rapids_tpu_torch.ops.window import WindowExec

__all__ = [
    "AggSpec", "AggregateInPandasExec", "Average", "BroadcastHashJoinExec",
    "BroadcastNestedLoopJoinExec", "CoGroupedMapInPandasExec",
    "CoalescePartitionsExec",
    "Count", "CountStar", "DeviceToHostExec", "Exec", "ExecContext",
    "ExpandExec", "FilterExec", "First", "FlatMapGroupsInPandasExec",
    "GenerateExec", "GlobalLimitExec",
    "HashAggregateExec", "HostToDeviceExec", "InMemorySourceExec", "Last",
    "LocalLimitExec", "MapInPandasExec", "Max", "Min", "ProjectExec",
    "RangeExec",
    "ShuffledHashJoinExec", "SortExec", "SortOrder", "Sum", "UnionExec",
    "WindowExec",
]
