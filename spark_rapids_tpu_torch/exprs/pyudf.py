"""Host-evaluated Python UDF expression (port of the JAX package's
``exprs/pyudf.py``) — the fallback half of the UDF tier
(GpuArrowEvalPythonExec.scala:494 analog: the reference ships columns to
Python workers over Arrow and reads results back; in-process, the device
path downloads the argument columns, applies the function over python
values, and uploads the result column).

Unlike ``host_roundtrip`` (the reference's other islands, which work on
the first ``num_rows`` rows), the download applies the batch's selection
vector and the results are spread back over its live positions, as the
reference's ``PythonUDF`` does. Its rows and bytes count as
``island.pyudf.rows / .bytesDown / .bytesUp`` in the running operator's
metrics (``island_sink``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.columnar.host import (
    HostBatch, HostColumn, download_batches, host_to_device)
from spark_rapids_tpu_torch.exprs.base import (
    Expression, as_device_column, as_host_column, host_column_bytes,
    island_sink)


class PythonUDF(Expression):
    """f(*args) applied row-wise with SQL-null passthrough of Nones."""

    def __init__(self, func, return_type: DataType, children,
                 reason: str = ""):
        self.func = func
        self._rt = return_type
        self._children = tuple(children)
        self.reason = reason        # why compilation failed (explain)

    @property
    def children(self) -> Tuple[Expression, ...]:
        return self._children

    @property
    def self_jittable(self) -> bool:
        return False

    def data_type(self) -> DataType:
        return self._rt

    def _apply(self, arg_lists: List[list], n: int) -> HostColumn:
        out = []
        for i in range(n):
            try:
                out.append(self.func(*[a[i] for a in arg_lists]))
            except Exception as e:
                raise RuntimeError(
                    f"python UDF "
                    f"{getattr(self.func, '__name__', 'udf')!r} failed "
                    f"on row {i}: {e}") from e
        return HostColumn.from_values(self._rt, out)

    def eval_host(self, batch: HostBatch) -> HostColumn:
        cols = [as_host_column(c.eval_host(batch), batch)
                for c in self._children]
        return self._apply([c.to_list() for c in cols], batch.num_rows)

    def eval(self, batch: DeviceBatch):
        cols = [as_device_column(c.eval(batch), batch)
                for c in self._children]
        moved: dict = {}
        hb = download_batches([DeviceBatch(tuple(cols), batch.num_rows,
                                           sel=batch.sel)], moved=moved)[0]
        out = self._apply([c.to_list() for c in hb.columns], hb.num_rows)
        if batch.sel is not None:
            # The download compacts selection vectors; re-expand results
            # to the batch's live positions so the column lines up
            # row-for-row.
            idx = np.flatnonzero(batch.row_mask().cpu().numpy())
            if self._rt.is_string:
                data = np.empty(batch.capacity, object)
                data[:] = b""
            else:
                data = np.zeros(batch.capacity, self._rt.np_dtype)
            validity = np.zeros(batch.capacity, np.bool_)
            data[idx] = out.data
            validity[idx] = out.validity
            out = HostColumn(self._rt, data, validity)
        dev = host_to_device(HostBatch(("c",), [out]),
                             capacity=batch.capacity, device=batch.device,
                             mode="plain")
        sink = island_sink.get()
        if sink is not None:
            sink.add("island.pyudf.rows", moved.get("rows", 0))
            sink.add("island.pyudf.bytesDown", moved.get("bytes", 0))
            sink.add("island.pyudf.bytesUp", host_column_bytes(out))
        return dev.columns[0]

    def pretty(self) -> str:
        return f"pyudf:{getattr(self.func, '__name__', 'udf')}"
