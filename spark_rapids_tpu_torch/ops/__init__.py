"""Physical operators of the port (see each module for its JAX
counterpart)."""

from spark_rapids_tpu_torch.ops.aggregate import (
    AggSpec, Average, Count, CountStar, HashAggregateExec, Max, Min, Sum)
from spark_rapids_tpu_torch.ops.base import (
    DeviceToHostExec, Exec, ExecContext, HostToDeviceExec,
    InMemorySourceExec)
from spark_rapids_tpu_torch.ops.basic import (
    CoalescePartitionsExec, ExpandExec, FilterExec, GlobalLimitExec,
    LocalLimitExec, ProjectExec)
from spark_rapids_tpu_torch.ops.join import BroadcastHashJoinExec
from spark_rapids_tpu_torch.ops.sort import SortExec, SortOrder
from spark_rapids_tpu_torch.ops.window import WindowExec

__all__ = [
    "AggSpec", "Average", "BroadcastHashJoinExec", "CoalescePartitionsExec",
    "Count", "CountStar", "DeviceToHostExec", "Exec", "ExecContext",
    "ExpandExec", "FilterExec", "GlobalLimitExec", "HashAggregateExec",
    "HostToDeviceExec", "InMemorySourceExec",
    "LocalLimitExec", "Max", "Min", "ProjectExec", "SortExec", "SortOrder",
    "Sum", "WindowExec",
]
