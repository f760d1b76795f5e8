"""Image files without OpenCV: ``imread_rgb`` and ``imwrite_jpeg``, the
port's ``cv2.imread(path)[..., ::-1]`` and ``cv2.imwrite(path, rgb[...,
::-1])`` for the JPEG and PNG files the label and training pipeline reads
and writes.

- :func:`imread_rgb` sniffs the format from the file's first bytes (JPEG's
  ``FF D8``, PNG's signature), never from its name, and decodes it with
  ``host_jpeg.decode_jpeg`` or ``host_png.decode_png``. A missing file, or
  one that is neither, returns ``None``, as ``cv2.imread`` does. A JPEG or
  PNG the codec does not handle raises with the reason: nothing falls back to
  another library, and no partial image is returned.
- :func:`imwrite_jpeg` writes ``host_jpeg.encode_jpeg``'s bytes, which are
  ``cv2.imencode(".jpg", ...)``'s at the same quality.
- EXIF orientation is read here for both formats (a JPEG's APP1, a PNG's
  ``eXIf``) and applied as OpenCV's ``ExifTransform`` applies it.

The bit-level work (Huffman coding, PNG's row filters) is the host C++
library ``csrc/host_codec.cpp``, built by :func:`codec` at first use into
the port's build directory (``_build.build_host``); it raises, and nothing
drops to a slower loop, where the library cannot be built or loaded.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from twinvoice_tpu_torch import _build

CODEC_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host_codec.cpp"
JPEG_SOI = b"\xff\xd8"
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
ORIENTATION_TAG = 0x0112
MAX_PIXELS = 1 << 30  # OpenCV's CV_IO_MAX_IMAGE_PIXELS: cv2 refuses a larger frame

_lock = threading.Lock()
_codec = None


def build_codec() -> Path:
    """Compile the codec library unless it is built already. → its path."""
    return _build.build_host(CODEC_SOURCE, "hostcodec", "image codec")


def codec() -> ctypes.CDLL:
    """The loaded codec library, built first if need be."""
    global _codec
    with _lock:
        if _codec is None:
            lib = ctypes.CDLL(str(build_codec()))
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            for fn in (lib.jpeg_decode_scan, lib.jpeg_decode_progressive_scan):
                fn.argtypes = [p, i64, i64, p, p, p, ctypes.POINTER(i64)]
                fn.restype = ctypes.c_int
            lib.jpeg_smooth_blocks.argtypes = [p, p, p, p, p]
            lib.jpeg_smooth_blocks.restype = ctypes.c_int
            lib.jpeg_encode_scan.argtypes = [p, p, p, p, i64]
            lib.jpeg_encode_scan.restype = i64
            lib.png_unfilter.argtypes = [p, i64, i64, ctypes.c_int32, p]
            lib.png_unfilter.restype = ctypes.c_int
            _codec = lib
        return _codec


def exif_orientation(tiff: bytes) -> int:
    """IFD0's Orientation (tag 0x0112) of a TIFF-structured EXIF block, in
    either byte order (``II`` or ``MM``), read as OpenCV's ``ExifReader``
    reads it: the SHORT at the entry's value field. 1 where the block has no
    such entry or is malformed."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    if struct.unpack_from(e + "H", tiff, 2)[0] != 42:
        return 1
    ifd = struct.unpack_from(e + "I", tiff, 4)[0]
    if ifd + 2 > len(tiff):
        return 1
    for i in range(struct.unpack_from(e + "H", tiff, ifd)[0]):
        off = ifd + 2 + 12 * i
        if off + 12 > len(tiff):
            return 1
        if struct.unpack_from(e + "H", tiff, off)[0] == ORIENTATION_TAG:
            return struct.unpack_from(e + "H", tiff, off + 8)[0]
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """The stored pixels → as shown, for EXIF orientations 1-8 (OpenCV's
    ``ExifTransform``: 2-4 flip, 5-8 transpose and then flip; 5-8 swap the
    sides). Any other value leaves the image as stored."""
    if 5 <= orientation <= 8:  # transposed, then flipped as 1-4 flip
        img, orientation = img.swapaxes(0, 1), orientation - 4
    if orientation == 2:
        img = img[:, ::-1]
    elif orientation == 3:
        img = img[::-1, ::-1]
    elif orientation == 4:
        img = img[::-1]
    return np.ascontiguousarray(img)


def imread_rgb(path) -> Optional[np.ndarray]:
    """The RGB uint8 (H, W, 3) array that ``cv2.imread(path)[..., ::-1]``
    returns for a JPEG (baseline, extended or progressive; gray, YCbCr,
    RGB-coded, CMYK or YCCK: ``host_jpeg.decode_jpeg``) or a PNG, EXIF
    orientation applied; ``None`` for a missing file or one that is neither.
    A JPEG form ``decode_jpeg`` refuses (lossless, arithmetic, hierarchical,
    12-bit, a bad progression, corrupt data) raises ``ValueError``."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if data[:2] == JPEG_SOI:
        from twinvoice_tpu_torch.ops.host_jpeg import decode_jpeg

        return decode_jpeg(data)
    if data[:8] == PNG_SIGNATURE:
        from twinvoice_tpu_torch.ops.host_png import decode_png

        return decode_png(data)
    return None


def imwrite_jpeg(path, rgb: np.ndarray, quality: int = 95) -> None:
    """Write ``rgb`` (uint8 (H, W, 3)) as the JPEG file ``cv2.imwrite(path,
    rgb[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])`` writes."""
    from twinvoice_tpu_torch.ops.host_jpeg import encode_jpeg

    data = encode_jpeg(rgb, quality)
    with open(path, "wb") as f:
        f.write(data)
