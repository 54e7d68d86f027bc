"""spark_rapids_tpu_torch: the PyTorch + CUDA port of ``spark_rapids_tpu``.

The JAX package beside this one is the reference: every module here mirrors
one there, under the same path and names, and the tests feed both the same
inputs. This package imports torch and numpy only. It never imports jax or
anything of ``spark_rapids_tpu``; what it needs of that package's host code
it keeps as its own copy.

Device rule for every entry point: ``device=None`` means the CUDA card. If
no CUDA device exists the call raises; it never falls back to the CPU
quietly. Callers that want the plain-PyTorch CPU path (the tests) pass
``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch

from spark_rapids_tpu_torch.version import __version__  # noqa: F401

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    """The CUDA card, or RuntimeError when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "spark_rapids_tpu_torch: no CUDA device is available; pass "
            "device='cpu' explicitly to run the plain-PyTorch path")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> :func:`default_device`; anything else is taken as
    given (``"cpu"``, ``"cuda"``, ``"cuda:1"``, a ``torch.device``)."""
    if device is None:
        return default_device()
    return torch.device(device)
