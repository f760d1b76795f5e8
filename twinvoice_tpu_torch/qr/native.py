"""ctypes binding for the in-repo C++ QR decoder (``native/qrdecode.cpp``),
the port's counterpart of ``twinvoice_tpu.qr.native``.

The library is built from the source where it lies, with the host C++
compiler, into the port's build directory at first use
(``_build.build_host``, keyed by a hash of the source and the flags). A
library built elsewhere (``native/libqrdecode.so``) is never loaded. Unlike the JAX binding, which returns no payload when the library is
missing, :func:`load` raises when it cannot build or load it, so a machine
without a compiler fails loudly and not as "no QR found".
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List

import numpy as np

from twinvoice_tpu_torch import _build

SOURCE = Path(__file__).resolve().parents[2] / "native" / "qrdecode.cpp"
OUT_CAP = 1 << 16  # bytes of NUL-separated payloads a call may return

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    return _build.host_library_path(SOURCE, "qrdecode")


def build() -> Path:
    """Compile the decoder unless it is built already. → the library's path.
    Raises with the compiler's output if the build fails."""
    return _build.build_host(SOURCE, "qrdecode", "QR decoder")


def load() -> ctypes.CDLL:
    """The loaded decoder library, built first if need be."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.qr_decode_gray.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ]
            lib.qr_decode_gray.restype = ctypes.c_int
            _lib = lib
        return _lib


def decode(image) -> List[str]:
    """Decode all QR codes in an image (uint8 RGB or gray ndarray, or a PIL
    image, read through its own ``convert("L")``). An RGB array is reduced to
    gray as the JAX binding does: float64 ``0.299R + 0.587G + 0.114B``,
    truncated to uint8."""
    lib = load()
    arr = np.asarray(image.convert("L") if hasattr(image, "convert") else image)
    if arr.ndim == 3:
        arr = (
            0.299 * arr[..., 0] + 0.587 * arr[..., 1] + 0.114 * arr[..., 2]
        ).astype(np.uint8)
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w = arr.shape
    buf = ctypes.create_string_buffer(OUT_CAP)
    n = lib.qr_decode_gray(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           h, w, w, buf, len(buf))
    out: List[str] = []
    raw = buf.raw
    pos = 0
    for _ in range(max(0, n)):
        end = raw.find(b"\0", pos)
        if end < 0:
            break
        out.append(raw[pos:end].decode("utf-8", errors="ignore"))
        pos = end + 1
    return out
