"""Configuration keys the port reads (a subset of the JAX package's
``config.py`` registry, under the same key names and defaults).

``TpuConf`` resolves values from a plain dict, the stand-in for Spark SQL
conf. Only the keys this slice consults are registered; later slices add
theirs here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class ConfEntry:
    key: str
    doc: str
    value_type: str            # "boolean" | "long" | "string"
    default: Any
    converter: Callable[[str], Any]

    def get(self, conf: "TpuConf") -> Any:
        raw = conf.raw.get(self.key)
        if raw is None:
            return self.default
        if isinstance(raw, str):
            return self.converter(raw)
        if self.value_type == "boolean":
            if not isinstance(raw, bool):
                raise ValueError(f"{self.key} expects a boolean, got {raw!r}")
            return raw
        if self.value_type == "string":
            return str(raw)
        return int(raw)


def _parse_bool(s: str) -> bool:
    v = s.strip().lower()
    if v in ("true", "1", "yes"):
        return True
    if v in ("false", "0", "no"):
        return False
    raise ValueError(f"not a boolean config value: {s!r}")


_REGISTRY: Dict[str, ConfEntry] = {}


def _entry(key: str, doc: str, value_type: str, default: Any) -> ConfEntry:
    conv = {"boolean": _parse_bool, "long": int, "string": str}[value_type]
    e = ConfEntry(key, doc, value_type, default, conv)
    _REGISTRY[key] = e
    return e


BATCH_SIZE_BYTES = _entry(
    "spark.rapids.sql.batchSizeBytes",
    "Target size in bytes for coalesced device batches.", "long",
    512 * 1024 * 1024)

BATCH_SIZE_ROWS = _entry(
    "spark.rapids.sql.batchSizeRows",
    "Target row capacity for coalesced device batches.", "long", 4 << 20)

HAS_NANS = _entry(
    "spark.rapids.sql.hasNans",
    "Assume floating point data may contain NaN/Infinity: sum/avg carry "
    "out-of-band non-finite occurrence streams through the cumsum path.",
    "boolean", True)

WIRE_CODEC = _entry(
    "spark.rapids.sql.wire.codec",
    "Host->device wire codec (columnar/wire.py): 'v2' (default: "
    "dictionary, narrow-int, RLE, delta and frame-of-reference encodings "
    "chosen per column by smallest wire size), 'v1' (dictionary + "
    "narrow-int only) or 'plain' (logical dtypes ship untransformed). "
    "Every codec is lossless, so all three give bit-identical results. "
    "The SRT_WIRE_CODEC env seeds the process default; the conf key "
    "overrides it. Process-global, adopted per collect.", "string", "v2")

WIRE_MIN_UPLOAD_BYTES = _entry(
    "spark.rapids.sql.wire.minUploadBytes",
    "Upload transfer coalescing threshold: consecutive packed batches of "
    "one source partition whose staging buffers are each below this many "
    "bytes share one host->device copy (InMemorySourceExec through "
    "wire.plan_upload_groups / wire.upload_packed_group; each member "
    "decodes off its own slice, so results are bit-identical). 0 disables "
    "grouping.", "long", 1 << 20)

STABLE_SORT = _entry(
    "spark.rapids.sql.stableSort.enabled",
    "Use stable sorting (matches Spark's sort for ties).", "boolean", True)


class TpuConf:
    """Resolved view over a raw key->value dict."""

    def __init__(self, raw: Optional[Dict[str, Any]] = None):
        self.raw = dict(raw or {})

    def get(self, entry: ConfEntry) -> Any:
        return entry.get(self)
