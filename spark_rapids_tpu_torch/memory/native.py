"""ctypes bindings for the native spill file (``native/spill_store.cpp``)
and the shared g++ build of the repository's host-side C++ sources.

Port of the JAX package's ``memory/native.py``. The sources under
``native/`` are compiled where they stand, with ``g++``, into
``build/host/lib<name>-<digest>.so`` under this package at first use; the
digest covers the source and the flags, so an edited source rebuilds.
The bindings are a plain C ABI over ctypes. A missing compiler or a
failed build raises: there is no pure-python stand-in.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

REPO_ROOT = Path(__file__).resolve().parent.parent.parent
NATIVE_DIR = REPO_ROOT / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "host"

GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def library_path(src: str) -> Path:
    """Where ``native/<src>`` builds to: keyed by its bytes and flags."""
    h = hashlib.sha256((NATIVE_DIR / src).read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(src).stem}-{h.hexdigest()[:16]}.so"


def compile_and_load(src: str) -> ctypes.CDLL:
    """Build ``native/<src>`` unless built, and load it (once a process).
    The build writes a temporary file and renames it into place, so
    concurrent processes never load a half-written library."""
    lib = _LIBS.get(src)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(src)
        if lib is not None:
            return lib
        out = library_path(src)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(NATIVE_DIR / src)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=300)
            except FileNotFoundError as e:
                raise RuntimeError(
                    f"g++ not found: it builds native/{src}") from e
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for native/{src} "
                                   f"(rc={proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, out)
        lib = _LIBS[src] = ctypes.CDLL(str(out))
        return lib


def load() -> ctypes.CDLL:
    """The spill-store library, with its signatures declared."""
    lib = compile_and_load("spill_store.cpp")
    lib.spill_store_create.restype = ctypes.c_void_p
    lib.spill_store_create.argtypes = [ctypes.c_char_p]
    lib.spill_store_write.restype = ctypes.c_int64
    lib.spill_store_write.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.spill_store_read.restype = ctypes.c_int64
    lib.spill_store_read.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_uint64]
    lib.spill_store_block_size.restype = ctypes.c_int64
    lib.spill_store_block_size.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.spill_store_free.restype = ctypes.c_int
    lib.spill_store_free.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.spill_store_allocated_bytes.restype = ctypes.c_uint64
    lib.spill_store_allocated_bytes.argtypes = [ctypes.c_void_p]
    lib.spill_store_file_bytes.restype = ctypes.c_uint64
    lib.spill_store_file_bytes.argtypes = [ctypes.c_void_p]
    lib.spill_store_destroy.restype = None
    lib.spill_store_destroy.argtypes = [ctypes.c_void_p]
    return lib


class NativeSpillFile:
    """One spill file, addressed by block ids (an unlinked temporary file
    under ``directory``, with a first-fit allocator over its ranges)."""

    def __init__(self, directory: str):
        self._lib = load()
        os.makedirs(directory, exist_ok=True)
        self._h = self._lib.spill_store_create(directory.encode())
        if not self._h:
            raise OSError(f"cannot create a spill file in {directory}")

    def write(self, data: bytes) -> int:
        bid = self._lib.spill_store_write(self._h, data, len(data))
        if bid < 0:
            raise OSError(f"spill write failed: errno {-bid}")
        return bid

    def read(self, block_id: int) -> bytes:
        size = self._lib.spill_store_block_size(self._h, block_id)
        if size < 0:
            raise KeyError(block_id)
        buf = ctypes.create_string_buffer(size)
        n = self._lib.spill_store_read(self._h, block_id, buf, size)
        if n < 0:
            raise OSError(f"spill read failed: errno {-n}")
        return buf.raw[:n]

    def free(self, block_id: int):
        self._lib.spill_store_free(self._h, block_id)

    @property
    def allocated_bytes(self) -> int:
        return self._lib.spill_store_allocated_bytes(self._h)

    @property
    def file_bytes(self) -> int:
        return self._lib.spill_store_file_bytes(self._h)

    def close(self):
        if self._h:
            self._lib.spill_store_destroy(self._h)
            self._h = None
