"""Physical operators of the port (see each module for its JAX
counterpart)."""

from spark_rapids_tpu_torch.ops.aggregate import (
    AggSpec, Average, Count, CountStar, HashAggregateExec, Max, Min, Sum)
from spark_rapids_tpu_torch.ops.base import (
    Exec, ExecContext, InMemorySourceExec)
from spark_rapids_tpu_torch.ops.basic import (
    CoalescePartitionsExec, FilterExec, GlobalLimitExec, LocalLimitExec,
    ProjectExec)
from spark_rapids_tpu_torch.ops.join import BroadcastHashJoinExec
from spark_rapids_tpu_torch.ops.sort import SortExec, SortOrder

__all__ = [
    "AggSpec", "Average", "BroadcastHashJoinExec", "CoalescePartitionsExec",
    "Count", "CountStar", "Exec", "ExecContext", "FilterExec",
    "GlobalLimitExec", "HashAggregateExec", "InMemorySourceExec",
    "LocalLimitExec", "Max", "Min", "ProjectExec", "SortExec", "SortOrder",
    "Sum",
]
