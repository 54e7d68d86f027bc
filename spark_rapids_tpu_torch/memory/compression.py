"""Compression codecs for the disk spill tier (port of the JAX package's
``memory/compression.py``; ref TableCompressionCodec.scala:41,107-128 and
its nvcomp LZ4 codec).

The disk tier's blobs are host bytes, so the codec runs on the host, in
native code (``native/compress.cpp``, a self-contained LZ4 block-format
implementation, built by ``memory/native.py``). Codecs:

- ``lz4``  - the native LZ4 block format; a failed build raises;
- ``copy`` - framing without a byte transform (the reference's test codec);
- ``none`` - no compression.
"""

from __future__ import annotations

import ctypes
from typing import Optional

from spark_rapids_tpu_torch.memory.native import compile_and_load


class CompressionCodec:
    """One codec: a name and compress / decompress over byte blobs."""

    name: str = "none"

    def compress(self, data: bytes) -> bytes:
        raise NotImplementedError

    def decompress(self, data: bytes, uncompressed_size: int) -> bytes:
        raise NotImplementedError


class CopyCodec(CompressionCodec):
    """Framing without a byte transform."""

    name = "copy"

    def compress(self, data: bytes) -> bytes:
        return data

    def decompress(self, data: bytes, uncompressed_size: int) -> bytes:
        if len(data) != uncompressed_size:
            raise OSError(f"copy codec blob is {len(data)} of "
                          f"{uncompressed_size} bytes")
        return data


class Lz4Codec(CompressionCodec):
    """LZ4 block format through ``native/compress.cpp``."""

    name = "lz4"

    def __init__(self):
        lib = compile_and_load("compress.cpp")
        lib.lz4_compress_bound.restype = ctypes.c_int64
        lib.lz4_compress_bound.argtypes = [ctypes.c_int64]
        lib.lz4_compress.restype = ctypes.c_int64
        lib.lz4_compress.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_char_p, ctypes.c_int64]
        lib.lz4_decompress.restype = ctypes.c_int64
        lib.lz4_decompress.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                       ctypes.c_char_p, ctypes.c_int64]
        self._lib = lib

    def compress(self, data: bytes) -> bytes:
        n = len(data)
        bound = self._lib.lz4_compress_bound(n)
        out = ctypes.create_string_buffer(bound)
        sz = self._lib.lz4_compress(data, n, out, bound)
        if sz < 0:
            raise OSError("lz4 compression failed")
        return out.raw[:sz]

    def decompress(self, data: bytes, uncompressed_size: int) -> bytes:
        out = ctypes.create_string_buffer(max(uncompressed_size, 1))
        sz = self._lib.lz4_decompress(data, len(data), out,
                                      uncompressed_size)
        if sz != uncompressed_size:
            raise OSError(f"lz4 decompression produced {sz} of "
                          f"{uncompressed_size} bytes")
        return out.raw[:uncompressed_size]


CODEC_NAMES = ("lz4", "copy", "none", "")


def get_codec(name: str) -> Optional[CompressionCodec]:
    """The codec registry (TableCompressionCodec.getCodec analog): None
    for ``none`` or an empty name (no compression)."""
    name = (name or "none").lower()
    if name in ("none", ""):
        return None
    if name == "copy":
        return CopyCodec()
    if name == "lz4":
        return Lz4Codec()
    raise ValueError(f"unknown compression codec {name!r}")
