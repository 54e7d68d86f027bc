"""Public DataFrame API of the port (SparkSession/DataFrame analogs)."""

from spark_rapids_tpu_torch.api.dataframe import (    # noqa: F401
    DataFrame, GroupedData, TpuSession)
from spark_rapids_tpu_torch.plan.logical import (     # noqa: F401
    agg_avg, agg_count, agg_first, agg_last, agg_max, agg_min, agg_sum, col,
    lit_col, monotonically_increasing_id, rand, spark_partition_id)
