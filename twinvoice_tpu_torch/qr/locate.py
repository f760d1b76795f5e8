"""QR locator: ``cv2.QRCodeDetector``'s own localisation, without OpenCV.

The JAX scan locates codes with ``detectMulti`` and, where that fails,
``detect`` (``twinvoice_tpu/qr/detect.py:_detect_gray``).
:func:`locate_qr_quads` returns what those two calls return, and
:func:`locate_qr_boxes` JAX's boxes of them: ``int()`` of each quad's min
and max (truncated, not clipped), kept where x2 > x1 and y2 > y1.

The algorithm is OpenCV 5.0's ``QRDetect`` and ``QRDetectMulti``
(objdetect), rebuilt step by step in the host C++ source
``csrc/host_qrlocate.cpp``, which the decoder's (``csrc/host_qrdecode.cpp``,
``qr.cvdecode``) includes: the two are one library, built at first use by
``_build.build_host``:

1. the frame is resized toward a 512-pixel shorter side (INTER_LINEAR_EXACT
   up, INTER_AREA down; :func:`resize_area_u8` makes the downscale) and
   binarised by ``adaptiveThreshold`` (a float32 83-tap Gaussian over
   replicated edges, C = 2);
2. rows are scanned for dark-light-dark-light-dark runs in the ratio
   1:1:3:1:1 and each run's centre is checked down its column;
3. the centres are counted (lines within 10 px share one) and clustered
   by ``kmeans`` with k-means++ seeding; the codes are grouped by the hulls
   of a second k-means over the page's contours;
4. each group's triangles are tried from the smallest area up: the corner
   finder is the right angle with the largest arm triangle, the corners come
   from the finders' outer rings (flood fill, convex hull, line
   intersections), and a quad is kept where the three finders lie inside it
   and its dark and light pixels balance.

k-means draws from OpenCV's generator (``cv::RNG``, multiply with carry),
whose state is per thread, as ``theRNG()``'s is: a scan's quads can depend
on the locator calls its thread made before (on 0.40× pages they do).
:func:`set_rng_seed` is ``cv2.setRNGSeed``'s counterpart for the calling
thread.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from twinvoice_tpu_torch import _build
from twinvoice_tpu_torch.ops.host_image import resize_area_u8

Box = Tuple[int, int, int, int]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host_qrlocate.cpp"
# the library is built from the decoder's source, which includes the
# locator's: one library, so the decoder's detect-and-decode calls draw from
# the same per-thread generator as the locator's (``qr.cvdecode``)
DECODER_SOURCE = SOURCE.with_name("host_qrdecode.cpp")
MAX_CODES = 64
_RNG_DEFAULT = 0xFFFFFFFF  # cv::RNG(0), a fresh thread's state

_lock = threading.Lock()
_lib = None


def build() -> Path:
    """Compile the locator and decoder library unless it is built already.
    → its path."""
    return _build.build_host(DECODER_SOURCE, "hostqr", "QR locator and decoder", deps=(SOURCE,))


def library() -> ctypes.CDLL:
    """The loaded locator library, built first if need be."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i32, i64, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64
            lib.qr_set_rng_state.argtypes = [u64]
            lib.qr_set_rng_state.restype = None
            lib.qr_rng_state.argtypes = []
            lib.qr_rng_state.restype = u64
            lib.qr_rng_next.argtypes = []
            lib.qr_rng_next.restype = ctypes.c_uint32
            lib.qr_kmeans.argtypes = [p, i64, i32, i32, ctypes.c_double, i32, p, p]
            lib.qr_kmeans.restype = ctypes.c_double
            lib.qr_gaussian_replicate.argtypes = [p, i32, i32, i32, p]
            lib.qr_gaussian_replicate.restype = None
            lib.qr_adaptive_threshold.argtypes = [p, i32, i32, i32, ctypes.c_double, p]
            lib.qr_adaptive_threshold.restype = None
            lib.qr_resize_linear_exact.argtypes = [p, i32, i32, i32, i32, p]
            lib.qr_resize_linear_exact.restype = None
            lib.qr_flood_fill.argtypes = [p, i32, i32, p, i32, i32]
            lib.qr_flood_fill.restype = None
            lib.qr_convex_hull.argtypes = [p, i64, i32, p]
            lib.qr_convex_hull.restype = i64
            lib.qr_find_contours.argtypes = [p, i32, i32, p, p, i64]
            lib.qr_find_contours.restype = i64
            lib.qr_detect_multi.argtypes = [p, i32, i32, p, i32, i32, p, i32]
            lib.qr_detect_multi.restype = i32
            lib.qr_detect.argtypes = [p, i32, i32, p, i32, i32, p]
            lib.qr_detect.restype = i32
            lib.qr_decode_quad.argtypes = [p, i32, i32, p, i32, p, i64, p, p]
            lib.qr_decode_quad.restype = i64
            lib.qr_detect_and_decode.argtypes = [p, i32, i32, p, i32, i32, p, i64]
            lib.qr_detect_and_decode.restype = i64
            lib.qr_detect_and_decode_multi.argtypes = [p, i32, i32, p, i32, i32, p, i64, p, i32]
            lib.qr_detect_and_decode_multi.restype = i64
            lib.qr_dec_homography.argtypes = [p, p, i32, i32, ctypes.c_double, p]
            lib.qr_dec_homography.restype = i32
            lib.qr_dec_warp_nearest.argtypes = [p, i32, i32, p, i32, i32, p]
            lib.qr_dec_warp_nearest.restype = i32
            lib.qr_dec_resize_area.argtypes = [p, i32, i32, i32, i32, p]
            lib.qr_dec_resize_area.restype = None
            lib.qr_dec_match_template.argtypes = [p, i32, i32, p, i32, i32, p]
            lib.qr_dec_match_template.restype = ctypes.c_double
            lib.qr_dec_perspective_transform.argtypes = [p, i32, p]
            lib.qr_dec_perspective_transform.restype = None
            _lib = lib
        return _lib


def _gray(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 2 or img.size == 0:
        raise ValueError(f"a non-empty uint8 (H, W) array, got {img.dtype} {img.shape}")
    return img


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


# ------------------------------------------------------------- the generator

def set_rng_seed(seed: int) -> None:
    """``cv2.setRNGSeed(seed)`` for the locator's generator on the calling
    thread: the state becomes ``seed`` (as a 64-bit unsigned), 0 meaning
    ``0xffffffff``."""
    seed = int(seed) & (2**64 - 1)
    library().qr_set_rng_state(seed if seed else _RNG_DEFAULT)


def rng_state() -> int:
    """The calling thread's generator state (64 bits)."""
    return int(library().qr_rng_state())


def rng_next() -> int:
    """One draw of ``cv::RNG::next()`` from the calling thread's generator."""
    return int(library().qr_rng_next())


# ---------------------------------------------------------- the primitives

def kmeans_pp(points: np.ndarray, k: int, attempts: int, max_count: int = 10,
              epsilon: float = 0.1):
    """``cv2.kmeans(points, k, None, (EPS + COUNT, max_count, epsilon),
    attempts, KMEANS_PP_CENTERS)`` on float32 (N, 2) points, drawing from the
    calling thread's generator. → (compactness, int32 labels (N,), float32
    centres (k, 2))."""
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 2)
    if not 0 < k <= len(pts):
        raise ValueError(f"1 <= k <= {len(pts)} clusters, got {k}")
    labels = np.zeros(len(pts), np.int32)
    centers = np.zeros((k, 2), np.float32)
    c = library().qr_kmeans(_ptr(pts), len(pts), int(k), int(max_count), float(epsilon),
                            int(attempts), _ptr(labels), _ptr(centers))
    return c, labels, centers


def gaussian_blur_replicate(gray: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.GaussianBlur(gray.astype(float32), (ksize, ksize), 0,
    borderType=cv2.BORDER_REPLICATE)``: → float32 (H, W)."""
    gray = _gray(gray)
    out = np.empty(gray.shape, np.float32)
    library().qr_gaussian_replicate(_ptr(gray), gray.shape[0], gray.shape[1], int(ksize), _ptr(out))
    return out


def adaptive_threshold(gray: np.ndarray, block: int = 83, c: float = 2.0) -> np.ndarray:
    """``cv2.adaptiveThreshold(gray, 255, ADAPTIVE_THRESH_GAUSSIAN_C,
    THRESH_BINARY, block, c)``."""
    gray = _gray(gray)
    out = np.empty_like(gray)
    library().qr_adaptive_threshold(_ptr(gray), gray.shape[0], gray.shape[1], int(block), float(c),
                                    _ptr(out))
    return out


def resize_linear_exact(gray: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(gray, (width, height), interpolation=INTER_LINEAR_EXACT)``."""
    gray = _gray(gray)
    out = np.empty((height, width), np.uint8)
    library().qr_resize_linear_exact(_ptr(gray), gray.shape[0], gray.shape[1], int(width), int(height),
                                     _ptr(out))
    return out


def flood_fill_mask(img: np.ndarray, mask: np.ndarray, seed) -> np.ndarray:
    """``cv2.floodFill(img, mask, seed, 255, 0, 0, cv2.FLOODFILL_MASK_ONLY)``:
    → the (H + 2, W + 2) mask after the fill, its border set to 1 as
    OpenCV sets it."""
    img = _gray(img)
    out = np.array(mask, np.uint8, order="C", copy=True)
    if out.shape != (img.shape[0] + 2, img.shape[1] + 2):
        raise ValueError(f"a {(img.shape[0] + 2, img.shape[1] + 2)} mask, got {out.shape}")
    library().qr_flood_fill(_ptr(img), img.shape[0], img.shape[1], _ptr(out), int(seed[0]), int(seed[1]))
    return out


def convex_hull(points: np.ndarray) -> np.ndarray:
    """``cv2.convexHull(points)`` of int32 or float32 (N, 2) points: → the
    hull's points in OpenCV's order, (M, 2) of the input's dtype."""
    pts = np.asarray(points)
    is_float = pts.dtype.kind == "f"
    pts = np.ascontiguousarray(pts, np.float32 if is_float else np.int32).reshape(-1, 2)
    idx = np.zeros(max(len(pts), 1), np.int32)
    n = library().qr_convex_hull(_ptr(pts), len(pts), int(is_float), _ptr(idx))
    return pts[idx[:n]]


def find_contours(binary: np.ndarray) -> List[np.ndarray]:
    """``cv2.findContours(binary, RETR_TREE, CHAIN_APPROX_SIMPLE)[0]`` (nonzero
    is foreground): → int32 (n, 2) arrays in OpenCV's order."""
    binary = _gray(binary)
    cap = binary.size + 16
    counts = np.zeros(cap, np.int32)
    pts = np.zeros((cap, 2), np.int32)
    n = library().qr_find_contours(_ptr(binary), binary.shape[0], binary.shape[1], _ptr(counts),
                                   _ptr(pts), cap)
    if n < 0:
        raise RuntimeError("find_contours: the point buffer is too small")
    ends = np.cumsum(counts[:n])
    return [pts[e - c:e].copy() for e, c in zip(ends, counts[:n])]


# ------------------------------------------------------------- the locator

def _shrunk(gray: np.ndarray) -> Optional[np.ndarray]:
    """The INTER_AREA downscale toward a 512-pixel shorter side, where the
    shorter side exceeds 512 (both detectors' ``init``)."""
    h, w = gray.shape
    min_side = float(min(h, w))
    if min_side <= 512.0:
        return None
    coeff = min_side / 512.0
    return resize_area_u8(gray, int(np.rint(w / coeff)), int(np.rint(h / coeff)))


def detect_multi(gray: np.ndarray) -> Optional[np.ndarray]:
    """``cv2.QRCodeDetector().detectMulti(gray)``: → float32 (n, 4, 2)
    quads, or None where it fails."""
    gray = _gray(gray)
    small = _shrunk(gray)
    quads = np.zeros((MAX_CODES, 4, 2), np.float32)
    sp = _ptr(small) if small is not None else None
    sh = small.shape if small is not None else (0, 0)
    n = library().qr_detect_multi(_ptr(gray), gray.shape[0], gray.shape[1], sp, sh[0], sh[1],
                                  _ptr(quads), MAX_CODES)
    return quads[:n].copy() if n > 0 else None


def detect(gray: np.ndarray) -> Optional[np.ndarray]:
    """``cv2.QRCodeDetector().detect(gray)``: → a float32 (4, 2) quad, or
    None where it fails."""
    gray = _gray(gray)
    small = _shrunk(gray)
    quad = np.zeros((4, 2), np.float32)
    sp = _ptr(small) if small is not None else None
    sh = small.shape if small is not None else (0, 0)
    ok = library().qr_detect(_ptr(gray), gray.shape[0], gray.shape[1], sp, sh[0], sh[1], _ptr(quad))
    return quad if ok else None


def locate_qr_quads(gray: np.ndarray) -> Tuple[bool, Optional[np.ndarray]]:
    """``detectMulti``, then ``detect`` where it fails, as the JAX scan calls
    them: → (found, float32 (n, 4, 2) quads in cv2's order, or None)."""
    quads = detect_multi(gray)
    if quads is None:
        quad = detect(gray)
        quads = quad[None] if quad is not None else None
    return quads is not None, quads


def locate_qr_boxes(gray: np.ndarray) -> List[Box]:
    """uint8 gray (H, W) → JAX's ``_detect_gray`` boxes ``(x1, y1, x2, y2)``
    of :func:`locate_qr_quads`: ``int()`` of each quad's extremes."""
    _, quads = locate_qr_quads(gray)
    boxes: List[Box] = []
    if quads is None:
        return boxes
    for q in quads:
        x1, y1 = q.min(axis=0)
        x2, y2 = q.max(axis=0)
        if x2 > x1 and y2 > y1:
            boxes.append((int(x1), int(y1), int(x2), int(y2)))
    return boxes
