"""ctypes binding for the in-repo C++ QR decoder (``native/qrdecode.cpp``),
the port's counterpart of ``twinvoice_tpu.qr.native``.

The library is built from the source where it lies, with the host C++
compiler, into the port's build directory (``_build.build_dir()``) at first
use, keyed by a hash of the source and the flags, as ``_build`` keys the CUDA
kernels. A library built elsewhere (``native/libqrdecode.so``) is never
loaded. Unlike the JAX binding, which returns no payload when the library is
missing, :func:`load` raises when it cannot build or load it, so a machine
without a compiler fails loudly and not as "no QR found".
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List

import numpy as np

from twinvoice_tpu_torch import _build

SOURCE = Path(__file__).resolve().parents[2] / "native" / "qrdecode.cpp"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
CXX_TIMEOUT_S = 300
OUT_CAP = 1 << 16  # bytes of NUL-separated payloads a call may return

_lock = threading.Lock()
_lib = None


def find_cxx() -> str:
    """``$CXX``, else ``c++``, ``g++`` or ``clang++`` on ``PATH``."""
    cxx = os.environ.get("CXX")
    if cxx:
        return cxx
    for name in ("c++", "g++", "clang++"):
        found = shutil.which(name)
        if found:
            return found
    raise FileNotFoundError("no C++ compiler: $CXX is unset and none of c++, "
                            "g++, clang++ is on PATH")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return _build.build_dir() / f"libqrdecode-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the decoder unless it is built already. → the library's path.
    Raises with the compiler's output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = [find_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=CXX_TIMEOUT_S)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"QR decoder build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


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
