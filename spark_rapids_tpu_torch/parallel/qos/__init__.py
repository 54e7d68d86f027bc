"""Serving QoS for the multi-query scheduler (port of the JAX package's
``parallel/qos/``).

When enabled it replaces the QueryManager's FIFO run queue with:

- **Priority classes** ``interactive`` / ``batch`` / ``background`` (per
  query by conf or the ``priority=`` kwarg of ``DataFrame.collect`` /
  ``submit``), drained by weighted fair queueing with a hard starvation
  bound (``policy.py``).
- **Shortest-job-first within a class** by the plan's cost estimate.
  The port has no cost model yet: its queries are un-priced, FIFO within
  their class.
- **Per-tenant quotas**: in-flight caps and owner-tagged catalog bytes
  (``quotas.py``).
- **Deadline-aware admission** (``admission.py``).

Off by default: ``spark.rapids.sql.scheduler.qos.enabled`` (the conf
wins) or the ``SRT_QOS`` environment variable. Off, the QueryManager's
FIFO path is the whole scheduler.
"""

from __future__ import annotations

import os
import threading
from typing import Dict

from spark_rapids_tpu_torch.parallel.qos.admission import QosPolicy
from spark_rapids_tpu_torch.parallel.qos.policy import (CLASS_RANK, CLASSES,
                                                        DEFAULT_CLASS,
                                                        WfqQueue,
                                                        parse_weights,
                                                        resolve_class)
from spark_rapids_tpu_torch.parallel.qos.quotas import (DEFAULT_TENANT,
                                                        TenantQuotas,
                                                        resolve_tenant)

__all__ = [
    "CLASSES", "CLASS_RANK", "DEFAULT_CLASS", "DEFAULT_TENANT",
    "QosPolicy", "TenantQuotas", "WfqQueue", "counters", "parse_weights",
    "qos_enabled", "reset_counters", "resolve_class", "resolve_tenant",
]

_COUNTER_LOCK = threading.Lock()
_COUNTERS: Dict[str, float] = {}


def _record(name: str, amount: float = 1) -> None:
    with _COUNTER_LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + amount


def counters() -> Dict[str, float]:
    """Process-global QoS counters: admissions per class
    (``admitted.<class>``), rejections by kind (``rejected.<kind>``),
    ``starvationBoundEngagements``, ``quotaEvictions`` and per-tenant
    plan-cache outcomes (``planCacheHit.<tenant>`` /
    ``planCacheMiss.<tenant>``)."""
    with _COUNTER_LOCK:
        return dict(_COUNTERS)


def reset_counters() -> None:
    with _COUNTER_LOCK:
        _COUNTERS.clear()


def qos_enabled(conf=None) -> bool:
    """The conf key wins; else the ``SRT_QOS`` environment variable;
    else the registered default (False)."""
    from spark_rapids_tpu_torch import config as C
    if conf is not None and conf.raw.get(C.QOS_ENABLED.key) is not None:
        return bool(conf.get(C.QOS_ENABLED))
    env = os.environ.get("SRT_QOS")
    if env is not None:
        return env.strip() not in ("", "0", "false", "no")
    return bool(C.QOS_ENABLED.default)
