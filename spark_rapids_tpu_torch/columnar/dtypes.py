"""SQL type system of the PyTorch port (a copy of the JAX package's
``columnar/dtypes.py``; the port keeps its own so it never imports that
package).

DATE is days-since-epoch int32 and TIMESTAMP is microseconds-since-epoch
int64 (UTC), matching Spark's internal Catalyst representation. Strings are
stored as a fixed-width padded byte matrix ``(capacity, width) uint8`` plus
an int32 length column (see columnar/batch.py); width is bucketed per
column by ``string_width_bucket``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataType:
    """A SQL-level column type.

    ``np_dtype`` is the physical element dtype of the backing device array.
    For STRING the backing array is uint8 with an extra width axis.
    """

    name: str
    np_dtype: np.dtype
    # Byte width of one element (strings: per byte; see Column for width axis).
    itemsize: int

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return self.name

    @property
    def is_string(self) -> bool:
        return self.name == "string"

    @property
    def is_integral(self) -> bool:
        return self.name in ("int8", "int16", "int32", "int64")

    @property
    def is_floating(self) -> bool:
        return self.name in ("float32", "float64")

    @property
    def is_numeric(self) -> bool:
        return self.is_integral or self.is_floating

    @property
    def is_datetime(self) -> bool:
        return self.name in ("date", "timestamp")

    @property
    def is_boolean(self) -> bool:
        return self.name == "bool"


BOOL = DataType("bool", np.dtype(np.bool_), 1)
INT8 = DataType("int8", np.dtype(np.int8), 1)
INT16 = DataType("int16", np.dtype(np.int16), 2)
INT32 = DataType("int32", np.dtype(np.int32), 4)
INT64 = DataType("int64", np.dtype(np.int64), 8)
FLOAT32 = DataType("float32", np.dtype(np.float32), 4)
FLOAT64 = DataType("float64", np.dtype(np.float64), 8)
# Spark DateType: days since unix epoch, int32.
DATE = DataType("date", np.dtype(np.int32), 4)
# Spark TimestampType: microseconds since unix epoch UTC, int64.
TIMESTAMP = DataType("timestamp", np.dtype(np.int64), 8)
STRING = DataType("string", np.dtype(np.uint8), 1)

ALL_TYPES = (BOOL, INT8, INT16, INT32, INT64, FLOAT32, FLOAT64, DATE,
             TIMESTAMP, STRING)

_BY_NAME = {t.name: t for t in ALL_TYPES}
# Convenience aliases matching Spark SQL names.
_BY_NAME.update({
    "boolean": BOOL, "byte": INT8, "short": INT16, "int": INT32,
    "integer": INT32, "long": INT64, "bigint": INT64, "float": FLOAT32,
    "double": FLOAT64,
})


def type_named(name: str) -> DataType:
    return _BY_NAME[name]


def common_numeric_type(a: DataType, b: DataType) -> DataType:
    """Spark's numeric widening for binary arithmetic operands."""
    if a == b:
        return a
    if not (a.is_numeric and b.is_numeric):
        raise TypeError(f"no common numeric type for {a} and {b}")
    if FLOAT64 in (a, b):
        return FLOAT64
    if FLOAT32 in (a, b):
        # Spark promotes (float, long) -> float? No: (float, long) -> float.
        return FLOAT32
    order = [INT8, INT16, INT32, INT64]
    return order[max(order.index(a), order.index(b))]


def from_numpy_dtype(dt: np.dtype) -> DataType:
    dt = np.dtype(dt)
    for t in (BOOL, INT8, INT16, INT32, INT64, FLOAT32, FLOAT64):
        if t.np_dtype == dt:
            return t
    if dt.kind in ("U", "S", "O"):
        return STRING
    if dt.kind == "M":
        return TIMESTAMP
    raise TypeError(f"unsupported numpy dtype {dt}")


# Default string width bucket ladder (bytes). Width is static under jit, so
# we bucket it like capacities to bound the number of compiled programs.
STRING_WIDTH_BUCKETS = (8, 16, 32, 64, 128, 256)


def string_width_bucket(max_len: int) -> int:
    for w in STRING_WIDTH_BUCKETS:
        if max_len <= w:
            return w
    # Very long strings fall back to the exact next multiple of 128.
    return ((max_len + 127) // 128) * 128
