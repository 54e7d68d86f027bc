"""Chrome trace-event rendering of the flight-recorder stream (port of the
JAX package's ``monitoring/chrome.py``; the cluster merge waits for the
cluster runtime).

The output is the Trace Event Format's JSON object flavor
(``{"traceEvents": [...]}``) that chrome://tracing and Perfetto's legacy
importer load directly. Mapping:

- ``pid`` = query id, with a ``process_name`` metadata event naming the
  track ``query <N>``, so queries render as separate process groups.
- ``tid`` = recording thread, named from the live thread names
  (``srt-prefetch-*``, ``srt-scan-read-*``, the collect thread): host
  prefetch, device dispatch and shuffle land on distinct tracks.
- spans are ``"X"`` complete events (ts/dur in microseconds, as the
  format requires), instants are ``"i"`` thread-scoped events.
"""

from __future__ import annotations

from typing import Dict, List


def to_chrome(events: List[tuple], thread_names: Dict[int, str],
              process_tag: str = "") -> dict:
    """Render recorder event tuples into one Chrome trace document.
    ``process_tag`` prefixes every process track name, so exports of
    several processes stay attributable side by side."""
    prefix = f"{process_tag} " if process_tag else ""
    trace: List[dict] = []
    seen_pids = set()
    seen_tids = set()
    for e in events:
        ph, name, cat, ts, dur, tid, qid, args = e
        if qid not in seen_pids:
            seen_pids.add(qid)
            trace.append({"ph": "M", "name": "process_name", "pid": qid,
                          "args": {"name": f"{prefix}query {qid}"}})
            trace.append({"ph": "M", "name": "process_sort_index",
                          "pid": qid, "args": {"sort_index": qid}})
        if (qid, tid) not in seen_tids:
            seen_tids.add((qid, tid))
            trace.append({"ph": "M", "name": "thread_name", "pid": qid,
                          "tid": tid,
                          "args": {"name": thread_names.get(
                              tid, f"thread-{tid}")}})
        ev = {"ph": ph, "name": name, "cat": cat, "pid": qid, "tid": tid,
              "ts": ts / 1e3}
        if ph == "X":
            ev["dur"] = (dur or 0) / 1e3
        else:
            ev["s"] = "t"
        if args:
            ev["args"] = dict(args)
        trace.append(ev)
    return {"traceEvents": trace, "displayTimeUnit": "ms"}
