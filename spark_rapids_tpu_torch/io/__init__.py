"""File I/O: scans and writers over the arrow host-decode bridge (port of
the JAX package's ``io``). pyarrow is imported inside the functions that
read or write, never when a module here is imported."""

from spark_rapids_tpu_torch.io.scan import (      # noqa: F401
    FileScanExec, infer_schema, make_scan_exec)
