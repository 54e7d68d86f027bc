"""Arrow <-> HostBatch bridge (port of the JAX package's
``io/arrow_convert.py``).

pyarrow does the host decode of every file format (columnar, vectorized
C++); the columns convert into the port's host layout (numpy values +
validity, strings as the dense ``str_matrix`` (n, w) uint8 +
``str_lengths`` int32 of ``columnar/host.py``), which the wire codec
(``columnar/wire.py``) packs for one host->device copy a batch, exactly
as it packs an in-memory source's batches.

pyarrow is imported inside each function, never at module import: the
port imports without it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.dtypes import DataType
from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn

_ARROW_TO_DT = None


def _arrow_to_dt_map() -> dict:
    global _ARROW_TO_DT
    if _ARROW_TO_DT is None:
        import pyarrow as pa
        _ARROW_TO_DT = {
            pa.bool_(): dt.BOOL,
            pa.int8(): dt.INT8,
            pa.int16(): dt.INT16,
            pa.int32(): dt.INT32,
            pa.int64(): dt.INT64,
            pa.float32(): dt.FLOAT32,
            pa.float64(): dt.FLOAT64,
            pa.date32(): dt.DATE,
            pa.string(): dt.STRING,
            pa.large_string(): dt.STRING,
            pa.binary(): dt.STRING,
        }
    return _ARROW_TO_DT


def arrow_type_to_dt(t) -> DataType:
    import pyarrow as pa
    table = _arrow_to_dt_map()
    if t in table:
        return table[t]
    if pa.types.is_timestamp(t):
        return dt.TIMESTAMP
    if pa.types.is_dictionary(t):
        return arrow_type_to_dt(t.value_type)
    raise TypeError(f"unsupported arrow type {t} "
                    "(supported: bool/int/float/date/timestamp/string)")


def dt_to_arrow_type(t: DataType):
    import pyarrow as pa
    if t.is_string:
        return pa.string()
    if t.name == "date":
        return pa.date32()
    if t.name == "timestamp":
        return pa.timestamp("us", tz="UTC")
    return pa.from_numpy_dtype(t.np_dtype)


def schema_from_arrow(sch) -> Tuple[Tuple[str, DataType], ...]:
    return tuple((f.name, arrow_type_to_dt(f.type)) for f in sch)


def arrow_to_host_batch(table,
                        schema: Optional[Sequence] = None) -> HostBatch:
    """One arrow table or record batch -> HostBatch."""
    import pyarrow as pa
    if isinstance(table, pa.RecordBatch):
        table = pa.Table.from_batches([table])
    table = table.combine_chunks()
    names = []
    cols: List[HostColumn] = []
    for ci, field in enumerate(table.schema):
        t = arrow_type_to_dt(field.type)
        arr = table.column(ci)
        chunk = arr.chunk(0) if arr.num_chunks else pa.array(
            [], type=field.type)
        if pa.types.is_dictionary(chunk.type):
            chunk = chunk.dictionary_decode()
        validity = np.asarray(chunk.is_valid())
        if t.is_string:
            m, lens = _arrow_strings_to_matrix(chunk, validity)
            names.append(field.name)
            cols.append(HostColumn(t, None, validity,
                                   str_matrix=m, str_lengths=lens))
            continue
        elif t.name == "timestamp":
            # Arrow timestamps may be s/ms/us/ns; normalize to us.
            c = chunk.cast(pa.timestamp("us"))
            data = np.asarray(c.cast(pa.int64()).fill_null(0),
                              dtype=np.int64)
        elif t.name == "date":
            data = np.asarray(chunk.cast(pa.int32()).fill_null(0),
                              dtype=np.int32)
        elif t.is_boolean:
            # The reference fills with the int 0, which pyarrow refuses
            # for a boolean column holding nulls.
            data = np.asarray(chunk.fill_null(False)).astype(np.bool_)
        else:
            data = np.asarray(chunk.fill_null(0)).astype(t.np_dtype)
        names.append(field.name)
        cols.append(HostColumn(t, data, validity))
    return HostBatch(tuple(names), cols)


def _arrow_strings_to_matrix(chunk, validity: np.ndarray):
    """Arrow string array -> ((n, w) uint8 matrix, int32 lengths): index
    math over the offsets and data buffers, no per-row Python loop. Null
    rows have length 0 and all-zero bytes; ``w`` is the longest value (at
    least 1)."""
    import pyarrow as pa
    n = len(chunk)
    if n == 0:
        return np.zeros((0, 1), np.uint8), np.zeros(0, np.int32)
    if pa.types.is_large_string(chunk.type) or \
            pa.types.is_large_binary(chunk.type):
        off_dt = np.int64
    else:
        off_dt = np.int32
    bufs = chunk.buffers()
    isz = np.dtype(off_dt).itemsize
    offs = np.frombuffer(bufs[1], dtype=off_dt, count=n + 1,
                         offset=chunk.offset * isz).astype(np.int64)
    blob = (np.frombuffer(bufs[2], dtype=np.uint8)
            if bufs[2] is not None else np.zeros(0, np.uint8))
    starts = offs[:-1]
    lens = (offs[1:] - starts).astype(np.int32)
    lens = np.where(validity, lens, 0).astype(np.int32)
    w = max(int(lens.max()), 1)
    pos = np.arange(w, dtype=np.int64)[None, :]
    mask = pos < lens[:, None]
    idx = np.where(mask, starts[:, None] + pos, 0)
    m = (blob[idx] if blob.size else
         np.zeros((n, w), np.uint8)) * mask.astype(np.uint8)
    return np.ascontiguousarray(m, dtype=np.uint8), lens


def host_batch_to_arrow(hb: HostBatch):
    """HostBatch -> arrow table (nulls from the validity; dates as
    date32, timestamps as UTC microseconds). Built from the numpy buffers
    without a per-row Python loop; a string column whose bytes are not
    valid UTF-8 goes through Python strings with replacement characters,
    as the reference's row loop makes them."""
    import pyarrow as pa
    arrays = []
    fields = []
    for name, c in zip(hb.names, hb.columns):
        at = dt_to_arrow_type(c.dtype)
        val = np.asarray(c.validity, np.bool_)
        mask = None if val.all() else ~val
        if c.dtype.is_string:
            arr = _strings_to_arrow(c, val)
        elif c.dtype.name == "timestamp":
            arr = pa.array(np.asarray(c.data, np.int64), type=pa.int64(),
                           mask=mask).cast(at)
        elif c.dtype.name == "date":
            arr = pa.array(np.asarray(c.data, np.int32), type=pa.int32(),
                           mask=mask).cast(at)
        else:
            arr = pa.array(np.ascontiguousarray(c.data, c.dtype.np_dtype),
                           type=at, mask=mask)
        arrays.append(arr)
        fields.append(pa.field(name, at))
    return pa.Table.from_arrays(arrays, schema=pa.schema(fields))


def _strings_to_arrow(c: HostColumn, val: np.ndarray):
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.host import strings_to_matrix
    m, lens = strings_to_matrix(c)
    n = len(val)
    lens = np.where(val, np.asarray(lens, np.int64), 0)
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    keep = np.arange(m.shape[1])[None, :] < lens[:, None]
    blob = np.ascontiguousarray(m)[keep]
    validity = None if val.all() else pa.py_buffer(np.packbits(
        val, bitorder="little").tobytes())
    arr = pa.StringArray.from_buffers(
        n, pa.py_buffer(offsets.tobytes()), pa.py_buffer(blob.tobytes()),
        validity, int(n - val.sum()))
    try:
        arr.validate(full=True)
    except pa.ArrowInvalid:
        arr = pa.array(c.to_list(), type=pa.string())
    return arr
