"""Zstandard decompression without the ``zstandard`` module: the frames of
Orbax checkpoints (TensorStore writes its OCDBT nodes and the zarr chunks of
``twinvoice_tpu.train.checkpoint.save`` with zstd), read by ``train/ocdbt.py``
and ``train/orbax.py``.

:func:`decompress` is ``zstandard.ZstdDecompressor().decompress`` for every
frame of its input back to back (RFC 8878: content sizes present or absent,
window descriptors, content checksums, raw, RLE and compressed blocks,
Huffman and FSE coding, repeat offsets, skippable frames). Frames that name
a dictionary are refused. The work is the host C++ library
``csrc/host_zstd.cpp``, built by :func:`library` at first use into the port's
build directory (``_build.build_host``).

A frame that declares, or grows to, more than ``max_out`` bytes raises before
or as the bytes are made, as ``host_png``'s inflation bound does; so does
every malformed input (``ValueError`` with the reason).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

from twinvoice_tpu_torch import _build

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host_zstd.cpp"
MAX_OUT = 1 << 31  # bytes: no checkpoint chunk of the JAX package comes near

ERRORS = {
    -1: "truncated frame",
    -2: "not a zstd frame (bad magic)",
    -3: "a reserved bit or block type is set",
    -4: "the frame names a dictionary, and none is known",
    -5: "the output would pass the bound",
    -6: "corrupt block, table or bitstream",
    -7: "content checksum mismatch",
    -8: "a match offset before the start of the frame",
    -9: "content size differs from the frame's header",
    -10: "out of memory",
}

_lock = threading.Lock()
_lib = None


def build() -> Path:
    """Compile the decompressor unless it is built already. → its path."""
    return _build.build_host(SOURCE, "hostzstd", "zstd decoder")


def library() -> ctypes.CDLL:
    """The loaded decompressor library, built first if need be."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64 = ctypes.c_int64
            lib.host_zstd_decompress.argtypes = [ctypes.c_char_p, i64, i64,
                                                 ctypes.POINTER(ctypes.c_void_p),
                                                 ctypes.POINTER(i64)]
            lib.host_zstd_decompress.restype = ctypes.c_int
            lib.host_zstd_free.argtypes = [ctypes.c_void_p]
            lib.host_zstd_free.restype = None
            lib.host_xxh64.argtypes = [ctypes.c_char_p, i64]
            lib.host_xxh64.restype = ctypes.c_uint64
            _lib = lib
        return _lib


def decompress(data: bytes, max_out: int = MAX_OUT) -> bytes:
    """Every zstd (and skippable) frame of ``data`` → the concatenated
    content. Raises ``ValueError`` naming what is wrong with a malformed,
    truncated or dictionary frame, or when the content passes ``max_out``
    bytes."""
    data = bytes(data)
    lib = library()
    out, n = ctypes.c_void_p(), ctypes.c_int64()
    rc = lib.host_zstd_decompress(data, len(data), int(max_out), ctypes.byref(out),
                                  ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"zstd: {ERRORS.get(rc, f'error {rc}')}")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.host_zstd_free(out)


def xxh64(data: bytes) -> int:
    """XXH64 of ``data`` with seed 0 (a zstd frame's checksum is its low 32
    bits)."""
    data = bytes(data)
    return int(library().host_xxh64(data, len(data)))
