"""``cv2.QRCodeDetector``'s decoder, without OpenCV.

The JAX scan's second decode backend (``twinvoice_tpu/qr/detect.py:
opencv_decode``) calls ``detectAndDecodeMulti`` and then ``detectAndDecode``
on a gray frame. :func:`detect_and_decode_multi` and
:func:`detect_and_decode` return what those return, and raise
:class:`CvError` where they raise ``cv2.error``; :func:`decode_quad` is
``decode`` on a given quad. The decoder is OpenCV 5.0's ``QRDecode`` and
``QRCodeDecoderImpl`` rebuilt in ``csrc/host_qrdecode.cpp``, one library
with the locator (``qr.locate``), whose per-thread generator k-means++
draws from: seed it with :func:`qr.locate.set_rng_seed` where cv2's would be
seeded with ``cv2.setRNGSeed``.

The payloads come back as cv2's Python binding hands them on: the bytes up
to the first NUL, decoded as strict UTF-8 (``UnicodeDecodeError`` where they
are not, as cv2 raises it). OpenCV itself re-encodes a byte-mode payload
that is neither ASCII nor valid UTF-8 as ISO-8859-1, so a Big5 payload comes
back as Latin-1 mojibake, exactly as from cv2.

No state is kept but the generator, which is per thread: the calls are safe
under ``extract_batch``'s thread pool.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from twinvoice_tpu_torch.qr import locate

OUT_CAP = 1 << 16  # payload bytes a call starts with; doubled while too small
MAX_CODES = locate.MAX_CODES


class CvError(RuntimeError):
    """Where cv2's call raises ``cv2.error`` (an OpenCV assertion or check)."""


def load() -> ctypes.CDLL:
    """The loaded locator and decoder library, built first if need be."""
    return locate.library()


def _gray(gray: np.ndarray) -> np.ndarray:
    gray = np.ascontiguousarray(gray)
    if gray.size == 0:
        raise CvError("empty image (cv2 asserts !img.empty())")
    if gray.dtype != np.uint8 or gray.ndim != 2:
        raise ValueError(f"a uint8 (H, W) array, got {gray.dtype} {gray.shape}")
    return gray


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _text(raw: bytes) -> str:
    """cv2's ``std::string`` → ``str``: C-string semantics, strict UTF-8."""
    return raw.split(b"\0", 1)[0].decode("utf-8")


def _call(fn, cap: int):
    """Run ``fn(buffer, cap)`` until the buffer is large enough (-3)."""
    while True:
        buf = np.zeros(cap, np.uint8)
        r = fn(buf, cap)
        if r == -3:
            cap *= 2
            continue
        if r == -2:
            raise CvError("OpenCV raises on this input")
        return r, buf


def detect_and_decode_multi(gray: np.ndarray) -> Tuple[bool, List[str]]:
    """``cv2.QRCodeDetector().detectAndDecodeMulti(gray)``'s ``(ok,
    decoded_info)``: one string a located code, "" for a code that does not
    decode; ``(False, [])`` where no code is located."""
    gray = _gray(gray)
    small = locate._shrunk(gray)
    sp = _ptr(small) if small is not None else None
    sh = small.shape if small is not None else (0, 0)
    lens = np.zeros(MAX_CODES, np.int64)
    lib = load()
    n, buf = _call(lambda b, cap: lib.qr_detect_and_decode_multi(
        _ptr(gray), gray.shape[0], gray.shape[1], sp, sh[0], sh[1], _ptr(b), cap, _ptr(lens),
        MAX_CODES), OUT_CAP)
    if n <= 0:
        return False, []
    texts, off = [], 0
    for ln in lens[:n]:
        texts.append(_text(bytes(buf[off:off + ln])))
        off += int(ln)
    return True, texts


def detect_and_decode(gray: np.ndarray) -> str:
    """``cv2.QRCodeDetector().detectAndDecode(gray)``'s payload ("" where
    none is located or it does not decode)."""
    gray = _gray(gray)
    small = locate._shrunk(gray)
    sp = _ptr(small) if small is not None else None
    sh = small.shape if small is not None else (0, 0)
    lib = load()
    n, buf = _call(lambda b, cap: lib.qr_detect_and_decode(
        _ptr(gray), gray.shape[0], gray.shape[1], sp, sh[0], sh[1], _ptr(b), cap), OUT_CAP)
    return _text(bytes(buf[:n]))


def decode_quad(gray: np.ndarray, quad, use_alignment: bool = True
                ) -> Tuple[Optional[str], Optional[np.ndarray]]:
    """``cv2.QRCodeDetector().decode(gray, quad)`` (with
    ``setUseAlignmentMarkers(use_alignment)``): → (payload, straight module
    grid, 0 dark and 255 light), or (None, None) where it does not decode.
    Raises :class:`CvError` where cv2 raises (a quad of zero area)."""
    gray = _gray(gray)
    if min(gray.shape) <= 20:
        return None, None  # cv2's checkQRInputImage refuses it
    q = np.ascontiguousarray(np.asarray(quad, np.float32).reshape(4, 2))
    grid = np.zeros(177 * 177, np.uint8)
    side = np.zeros(1, np.int32)
    lib = load()
    n, buf = _call(lambda b, cap: lib.qr_decode_quad(
        _ptr(gray), gray.shape[0], gray.shape[1], _ptr(q), int(bool(use_alignment)), _ptr(b), cap,
        _ptr(grid), _ptr(side)), OUT_CAP)
    if n < 0:
        return None, None
    s = int(side[0])
    return _text(bytes(buf[:n])), grid[:s * s].reshape(s, s).copy()
