"""Query flight recorder + live telemetry plane (port of the JAX
package's ``monitoring/`` package).

- :mod:`recorder`: bounded per-query ring buffers of spans/instants,
  with a near-zero disabled path (``spark.rapids.sql.trace.*``).
- :mod:`chrome`: Chrome trace-event JSON (Perfetto / chrome://tracing).
- :mod:`analyze`: the ``explain_analyze`` renderer (observed metrics).
- :mod:`syncs`: host-sync funnel attribution on the same span stream.
- :mod:`telemetry`: process-global typed metric registry (counters /
  gauges / sliding-window histograms, ``spark.rapids.sql.metrics.*``).
- :mod:`exporter`: OpenMetrics HTTP scrape surface on localhost.
- :mod:`history`: persistent per-query JSONL event log
  (``spark.rapids.sql.eventLog.dir``) + post-hoc report readers.

Import cost matters: this package (like faults.py) is imported from
deep dispatch code, so the recorder and telemetry import only the
standard library and everything engine-shaped is lazy.
"""

from spark_rapids_tpu_torch.monitoring import history, telemetry  # noqa: F401
from spark_rapids_tpu_torch.monitoring.recorder import (  # noqa: F401
    LEVEL_KERNEL, LEVEL_OPERATOR, LEVEL_QUERY, category_breakdown,
    configure, enabled, events, export_chrome, instant, level,
    maybe_configure, now_ns, open_span_count, process_tag, query_ids,
    record_span, reset, set_process_tag, snapshot, span, thread_names,
    trace_enabled)
