"""Structural fingerprints (port of the JAX package's
``ops/kernel_cache.py``, its keys only).

In the JAX package this module is a process-global LRU of ``jax.jit``
programs keyed by (kind, expression-tree fingerprint, input schema,
capacity bucket, bind arity, live native kernels), so a fresh plan of a
known shape skips tracing and compiling. The port compiles nothing at
query time (its CUDA kernels are built once, ``ops/cuda_build.py``) and a
per-batch step is an eager closure that costs nothing to build, so it
ports the keys and no cache: the LRU, its ``kernelCache.maxEntries`` bound
and the host closure cache come with CUDA-graph capture, which has
something worth keeping per key.

- :func:`fingerprint` is a generic structural walk (type names, scalar
  attributes, recursion into nested objects and arrays). Floats go
  through ``repr`` so NaN keys equal themselves; callables hash by
  qualname and bytecode; arrays and tensors by content digest. A
  ``BindSlotExpr`` folds to ``("bindslot", slot, dtype)``: two bindings of
  one dtype fingerprint alike, the value being a 0-d tensor argument.
- :func:`schema_fingerprint` keys an exec's output schema (the plan
  cache's in-memory source arm uses it).
- :func:`call` is the reference's ``kernel_cache.call`` dispatch funnel
  without the cache: one operator step under the OOM escalation ladder
  (``memory/oom.py``) with the ``kernel`` fault-injection site inside
  the retried call. Every per-batch step of Project, Filter, the fused
  stage, sort and window, aggregate, join, generate and the exchange
  split calls it. The reference's aggregate, join and exchange split
  look their programs up in its cache but dispatch them without
  ``call``, so they carry no ``kernel`` site there; the first step a
  query dispatches, which ``oom@kernel:1`` hits, is the same in both.

The JAX package's persistent (on-disk) compilation cache
(``configure_persistent``, ``kernelCache.persistentDir``) wraps XLA's and
is not ported: there is nothing to persist.
"""

from __future__ import annotations

import hashlib
from typing import Any, List, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Structural fingerprints
# ---------------------------------------------------------------------------

def fingerprint(obj: Any) -> Any:
    """Hashable structural fingerprint of ``obj``: two objects with equal
    fingerprints denote the same per-batch computation."""
    return _fp(obj, 0)


_MAX_DEPTH = 32


def _fp(v: Any, depth: int) -> Any:
    if depth > _MAX_DEPTH:
        raise ValueError("fingerprint recursion too deep (cyclic kernel "
                         "descriptor?)")
    if v is None or isinstance(v, (bool, int, str, bytes)):
        return v
    if isinstance(v, float):
        # repr: NaN != NaN would make any NaN-bearing key unfindable.
        return ("f", repr(v))
    if isinstance(v, np.dtype):
        return ("npdt", v.str)
    if isinstance(v, np.generic):
        return ("npv", v.dtype.str, repr(v.item()))
    if type(v).__name__ == "BindSlotExpr":
        # Value-free by construction: (slot, dtype) only. Duck-typed on
        # the class name so this module imports nothing of the engine.
        return ("bindslot", v.slot, v.dtype.name)
    if isinstance(v, (list, tuple)):
        return tuple(_fp(x, depth + 1) for x in v)
    if isinstance(v, (set, frozenset)):
        return ("set",) + tuple(sorted(repr(_fp(x, depth + 1)) for x in v))
    if isinstance(v, dict):
        return ("dict",) + tuple(
            (_fp(k, depth + 1), _fp(x, depth + 1))
            for k, x in sorted(v.items(), key=lambda kv: repr(kv[0])))
    if isinstance(v, np.ndarray):
        if v.dtype == object:
            # Object arrays (host string columns): content, not pointers.
            return ("ndo", v.shape) + tuple(
                _fp(x, depth + 1) for x in v.ravel().tolist())
        return ("nd", v.dtype.str, v.shape,
                hashlib.sha1(np.ascontiguousarray(v).tobytes())
                .hexdigest())
    if type(v).__module__ == "torch" and type(v).__name__ in (
            "Tensor", "Parameter"):
        # By content, read on the host (a tensor's address is no key).
        return ("tensor", str(v.dtype)) + _fp(
            v.detach().cpu().contiguous().numpy(), depth + 1)[1:]
    if type(v).__module__ == "torch" and type(v).__name__ in (
            "dtype", "device"):
        return ("torch", str(v))
    if callable(v) and not hasattr(v, "__dict__"):
        code = getattr(v, "__code__", None)
        return ("fn", getattr(v, "__qualname__", type(v).__name__),
                hashlib.sha1(code.co_code).hexdigest() if code else "")
    # Generic object: type identity + instance attributes (expression
    # trees, sort orders, agg specs, data types, host batches).
    d = getattr(v, "__dict__", None)
    if d is not None:
        code = getattr(v, "__code__", None)
        parts: List[Any] = ["obj", type(v).__module__, type(v).__qualname__]
        if code is not None:  # a function that also has attributes
            parts.append(hashlib.sha1(code.co_code).hexdigest())
        attrs = tuple((k, _fp(x, depth + 1))
                      for k, x in sorted(d.items())
                      if not k.startswith("_jit")
                      and not k.startswith("_phys"))
        return tuple(parts) + attrs
    # Opaque leaf with no visible state: its type, and its repr unless
    # that carries an address (which would poison keys).
    r = repr(v)
    if "0x" in r:
        r = type(v).__qualname__
    return ("opaque", type(v).__module__, type(v).__qualname__, r)


def schema_fingerprint(schema) -> Tuple:
    """Fingerprint of an exec output schema ((name, DataType), ...)."""
    return tuple((n, t.name) for n, t in schema)


# ---------------------------------------------------------------------------
# The dispatch funnel
# ---------------------------------------------------------------------------

def call(fn, *args, **kwargs):
    """Run one operator step ``fn(*args, **kwargs)`` under the OOM ladder,
    the ``kernel`` fault site inside the retried call. Steps are pure
    batch -> batch, so a retry is safe."""
    from spark_rapids_tpu_torch import faults
    from spark_rapids_tpu_torch.memory.oom import retry_on_oom

    def dispatch():
        faults.fault_point("kernel")
        return fn(*args, **kwargs)

    return retry_on_oom(dispatch)
