"""Host-sync attribution on the span stream (port of the JAX package's
``monitoring/syncs.py``, on torch's sync funnels).

A device->host read makes the host wait for every kernel queued before
it, so on the card a query's wall is its dispatch plus the waits at its
syncs. This wraps torch's explicit device->host funnels:
``torch.Tensor.item`` / ``tolist`` / ``cpu`` / ``numpy``, ``__bool__`` /
``__int__`` / ``__float__`` / ``__index__``, ``Tensor.to`` when the
target is the CPU and the copy is blocking (a ``non_blocking=True`` copy
returns at once; the wait comes at the sync after it), and
``torch.cuda.synchronize``,
``torch.cuda.Event.synchronize`` and ``torch.cuda.Stream.synchronize``.
Each blocking call on a CUDA tensor records a ``sync`` span
(LEVEL_KERNEL) whose args carry the innermost two port call sites, so
the spans interleave with the operator, upload and shuffle spans on one
timeline. A CPU tensor never syncs and records nothing.

torch also waits for the device inside ops whose output size depends on
the data (``nonzero``, boolean-mask indexing, ``torch.unique``,
``masked_select``, ``repeat_interleave`` without ``output_size``). Those
have no Python funnel to wrap: the spans miss them, and
``torch.cuda.set_sync_debug_mode("warn")`` counts them instead.

Install once per process (:func:`install`; ``profile_query.py`` and
``chip_smoke.py`` do, nothing does on import); the wrappers stay
resident but record nothing while the recorder is disabled or below
LEVEL_KERNEL.
"""

from __future__ import annotations

import traceback
from typing import Dict, List, Tuple

from spark_rapids_tpu_torch.monitoring import recorder

_INSTALLED = False

# (owner, attribute, original, owner defined it itself) per wrapped
# funnel, so a test can put every original back.
_PATCHED: List[tuple] = []

_TENSOR_FUNNELS = ("item", "tolist", "cpu", "numpy", "__bool__",
                   "__int__", "__float__", "__index__")


def _site() -> str:
    """Innermost TWO spark_rapids_tpu_torch frames (helper + its
    caller)."""
    frames = []
    for f in reversed(traceback.extract_stack()):
        if "spark_rapids_tpu_torch" in f.filename and \
                "/monitoring/" not in f.filename:
            short = f.filename.split("spark_rapids_tpu_torch/")[-1]
            frames.append(f"{short}:{f.lineno} {f.name}")
            if len(frames) == 2:
                break
    return " <- ".join(frames) if frames else "<outside engine>"


def _is_device(t) -> bool:
    """Whether a read of ``t`` waits for the card."""
    return t.is_cuda


def _recording() -> bool:
    return recorder.enabled() and recorder.level() >= recorder.LEVEL_KERNEL


def _span(label: str, fn, *a, **k):
    with recorder.span(label, "sync", level=recorder.LEVEL_KERNEL,
                       args={"site": _site()}):
        return fn(*a, **k)


def _wrap_tensor(fn, label: str):
    def wrapper(self, *a, **k):
        if not _recording() or not _is_device(self):
            return fn(self, *a, **k)
        return _span(label, fn, self, *a, **k)
    wrapper.__wrapped__ = fn
    return wrapper


def _blocking_copy_to_cpu(a, k) -> bool:
    """Whether ``Tensor.to(*a, **k)`` is a blocking copy to the CPU. The
    first positional bool after the target is ``non_blocking``."""
    nb = k.get("non_blocking")
    if nb is None:
        nb = next((x for x in a[1:] if isinstance(x, bool)), False)
    return not nb and _to_target_is_cpu(a, k)


def _to_target_is_cpu(a, k) -> bool:
    target = k.get("device")
    if target is None and a:
        target = a[0]
    if target is None:
        return False
    import torch
    if isinstance(target, torch.Tensor):
        return target.device.type == "cpu"
    if isinstance(target, (str, torch.device)):
        return torch.device(target).type == "cpu"
    return False            # a dtype: no device move


def _wrap_to(fn):
    def wrapper(self, *a, **k):
        if not _recording() or not _is_device(self) or \
                not _blocking_copy_to_cpu(a, k):
            return fn(self, *a, **k)
        return _span("to", fn, self, *a, **k)
    wrapper.__wrapped__ = fn
    return wrapper


def _wrap_device_wait(fn, label: str):
    def wrapper(*a, **k):
        if not _recording():
            return fn(*a, **k)
        return _span(label, fn, *a, **k)
    wrapper.__wrapped__ = fn
    return wrapper


def _patch(owner, name: str, wrapper) -> None:
    _PATCHED.append((owner, name, getattr(owner, name),
                     name in owner.__dict__))
    setattr(owner, name, wrapper)


def install() -> None:
    """Wrap torch's sync funnels (idempotent)."""
    global _INSTALLED
    if _INSTALLED:
        return
    import torch
    for m in _TENSOR_FUNNELS:
        _patch(torch.Tensor, m, _wrap_tensor(getattr(torch.Tensor, m), m))
    _patch(torch.Tensor, "to", _wrap_to(torch.Tensor.to))
    _patch(torch.cuda, "synchronize",
           _wrap_device_wait(torch.cuda.synchronize, "synchronize"))
    _patch(torch.cuda.Event, "synchronize",
           _wrap_device_wait(torch.cuda.Event.synchronize,
                             "event.synchronize"))
    _patch(torch.cuda.Stream, "synchronize",
           _wrap_device_wait(torch.cuda.Stream.synchronize,
                             "stream.synchronize"))
    _INSTALLED = True


def sync_stats(query_id=None) -> Dict[str, Tuple[int, float]]:
    """Aggregate recorded sync spans: ``label @ site`` -> (count, secs)."""
    stats: Dict[str, List[float]] = {}
    for e in recorder.events(query_id):
        ph, name, cat, ts, dur, tid, qid, args = e
        if ph != "X" or cat != "sync":
            continue
        a = args or {}
        # timed(m, "sizesPullTime") spans are syncs too: their "site" is
        # the metric name on the owning operator.
        site = a.get("site") or a.get("metric") or "<unknown>"
        s = stats.setdefault(f"{name} @ {site}", [0, 0.0])
        s[0] += 1
        s[1] += dur / 1e9
    return {k: (int(v[0]), v[1]) for k, v in stats.items()}
