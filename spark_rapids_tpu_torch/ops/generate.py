"""GenerateExec: explode / posexplode / explode_outer (port of the JAX
package's ``ops/generate.py``; ref GpuGenerateExec.scala).

The type envelope is scalar-only (the reference's isSupportedType gate),
so the generator is ``explode(array(e1, .., ek))``: an inline array of K
element expressions per row. Row i expands to K output rows, adjacent and
in element order (Spark's order); companion columns repeat.

Device half: K is static, so the expansion is one gather at capacity
``bucket_capacity(cap * K)``: output slot s reads row ``s // K`` and
element ``s % K``; string elements are first repadded to one width. A
compaction drops padding and, with ``skip_nulls``, NULL elements.

Host half: the same rows in the same order, vectorized in numpy (the
kept (row, element) pairs of the row-major K-wide grid, then one take a
column), where the reference loops over rows in Python.

``kernel_cache``'s jit of the device half is not ported (eager torch).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import (
    DeviceBatch, DeviceColumn, bucket_capacity, string_repad)
from spark_rapids_tpu_torch.columnar.host import (
    HostBatch, HostColumn, all_valid, strings_to_matrix)
from spark_rapids_tpu_torch.exprs.base import (
    Expression, as_device_column, as_host_column)
from spark_rapids_tpu_torch.ops import kernel_cache as kc
from spark_rapids_tpu_torch.ops.base import Exec, Schema, record_batch, timed


class GenerateExec(Exec):
    """explode / posexplode of an inline array over each input row."""

    def __init__(self, child: Exec, elements: Sequence[Expression],
                 position: bool = False, outer: bool = False,
                 element_name: str = "col", skip_nulls: bool = False):
        """``skip_nulls`` drops NULL elements (emulating variable-length
        arrays by NULL padding); ``outer`` then still emits one all-NULL
        row for a row whose every element is NULL (explode_outer). With
        ``skip_nulls`` False (Spark's semantics for an inline array, which
        is never NULL) every row emits exactly K rows, NULLs included."""
        super().__init__(child)
        assert elements, "explode of empty array"
        self.elements = list(elements)
        self.position = position
        self.outer = outer
        self.skip_nulls = skip_nulls
        self.element_name = element_name
        t0 = self.elements[0].data_type()
        for e in self.elements[1:]:
            assert e.data_type() == t0, "array elements must share a type"
        self._elem_type = t0

    @property
    def schema(self) -> Schema:
        base = list(self.children[0].schema)
        if self.position:
            base.append(("pos", dt.INT32))
        base.append((self.element_name, self._elem_type))
        return tuple(base)

    # -- device --------------------------------------------------------------
    def _kernel(self, batch: DeviceBatch) -> DeviceBatch:
        cap = batch.capacity
        k = len(self.elements)
        dev = batch.device
        elems = [as_device_column(e.eval(batch), batch)
                 for e in self.elements]
        if self._elem_type.is_string:
            w = max(c.string_width for c in elems)
            elems = [string_repad(c, w) for c in elems]
        out_cap = bucket_capacity(cap * k)
        slots = torch.arange(out_cap, dtype=torch.int64, device=dev)
        ei = slots % k
        rr = torch.clamp(slots // k, max=cap - 1)
        live = batch.row_mask().index_select(0, rr) & (slots < cap * k)
        # Element value and validity per slot: one gather over the K
        # element columns laid end to end.
        src = ei * cap + rr
        evalid = torch.cat([c.validity for c in elems])
        vvalid = evalid.index_select(0, src) & live
        val = torch.cat([c.data for c in elems]).index_select(0, src)
        if not self.skip_nulls:
            keep = live
        else:
            keep = live & vvalid
            if self.outer:
                # explode_outer: a row with no element left emits one
                # all-NULL element row (at element 0).
                none_valid = ~torch.stack([c.validity for c in elems]) \
                    .any(dim=0)
                keep = keep | (live & none_valid.index_select(0, rr)
                               & (ei == 0))
        out_cols: List[DeviceColumn] = [c.gather(rr, live)
                                        for c in batch.columns]
        if self.position:
            out_cols.append(DeviceColumn(
                dt.INT32, torch.where(live, ei, 0).to(torch.int32), live))
        if self._elem_type.is_string:
            lens = torch.cat([c.lengths for c in elems]).index_select(0, src)
            out_cols.append(DeviceColumn(
                self._elem_type, torch.where(vvalid[:, None], val, 0),
                vvalid, torch.where(vvalid, lens, 0)))
        else:
            out_cols.append(DeviceColumn(
                self._elem_type, torch.where(vvalid, val, torch.zeros(
                    (), dtype=val.dtype, device=dev)), vvalid))
        expanded = DeviceBatch(tuple(out_cols), torch.tensor(
            cap * k, dtype=torch.int32, device=dev))
        # Dense rows first: compact away the dropped slots (padding, and
        # NULL elements with skip_nulls); keep already excludes dead rows.
        return expanded.compact(keep)

    def execute_device(self, ctx, partition):
        m = ctx.metrics_for(self)
        for batch in self.children[0].execute_device(ctx, partition):
            with timed(m):
                out = kc.call(self._kernel, batch)
            record_batch(m, out)
            yield out

    # -- host ----------------------------------------------------------------
    def _host_kernel(self, hb: HostBatch) -> HostBatch:
        k = len(self.elements)
        elems = [as_host_column(e.eval_host(hb), hb) for e in self.elements]
        evalid = np.stack([np.asarray(c.validity, np.bool_) for c in elems],
                          axis=1).reshape(hb.num_rows, k)
        if not self.skip_nulls:
            keep = np.ones_like(evalid)
        else:
            keep = evalid.copy()
            if self.outer:
                keep[:, 0] |= ~evalid.any(axis=1)
        flat = np.flatnonzero(keep.ravel())
        row, ei = flat // k, flat % k
        cols = [c.take(row) for c in hb.columns]
        if self.position:
            cols.append(HostColumn(dt.INT32, ei.astype(np.int32),
                                   all_valid(len(flat))))
        validity = evalid[row, ei]
        if self._elem_type.is_string:
            mats = [strings_to_matrix(c) for c in elems]
            w = max(m.shape[1] for m, _ in mats)
            stacked = np.zeros((hb.num_rows, k, w), np.uint8)
            for j, (m, _) in enumerate(mats):
                stacked[:, j, :m.shape[1]] = m
            lens = np.stack([ln for _, ln in mats], axis=1).reshape(
                hb.num_rows, k)[row, ei]
            data = stacked[row, ei] * validity[:, None].astype(np.uint8)
            cols.append(HostColumn(
                self._elem_type, None, validity, str_matrix=data,
                str_lengths=np.where(validity, lens, 0).astype(np.int32)))
        else:
            data = np.stack([np.asarray(c.data) for c in elems], axis=1) \
                .reshape(hb.num_rows, k)[row, ei]
            data = np.where(validity, data, np.zeros((), data.dtype))
            cols.append(HostColumn(self._elem_type, data, validity))
        return HostBatch(tuple(n for n, _ in self.schema), cols)

    def execute_host(self, ctx, partition):
        for hb in self.children[0].execute_host(ctx, partition):
            yield self._host_kernel(hb)
