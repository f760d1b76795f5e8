"""Host image steps in numpy, for a machine without OpenCV or Pillow.

The JAX package calls OpenCV and Pillow on the host: the recognizer and
detector (``ocr/jaxocr/engine.py``, ``detector.py``, ``textness.py``), the
segmenter's host resize (``infer/pipeline.py``), the QR scan
(``qr/detect.py``) and the line renderer (``ocr/jaxocr/data.py``:
``dilate2x2``, ``resize_area_f32``, ``resize_linear_f32``, held in
``tests/test_torch_render.py``). Each function here computes what that call computes on
uint8 (or float32) arrays, with the library's own fixed-point or float32
arithmetic where it has one, so the boxes, strings and payloads the port
reads are the JAX package's. ``tests/test_torch_host_image.py`` holds each
against ``cv2`` or Pillow on seeded sweeps.
"""

from __future__ import annotations

import functools
import math

import numpy as np

# cv2.COLOR_RGB2GRAY on uint8: ITU-R 601 luma in 15-bit fixed point
_GRAY_SHIFT = 15
_R2Y, _G2Y, _B2Y = 9798, 19235, 3735

# cv2.INTER_LINEAR on uint8: 11-bit interpolation coefficients
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _require_pixels(img: np.ndarray, what: str):
    """OpenCV rejects an empty image in these calls; so does the port."""
    if img.size == 0:
        raise ValueError(f"{what}: empty image {img.shape}")


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) RGB → uint8 (H, W) luma, as
    ``cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)``."""
    c = rgb.astype(np.int32)
    y = c[..., 0] * _R2Y + c[..., 1] * _G2Y + c[..., 2] * _B2Y
    return ((y + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT).astype(np.uint8)


def otsu_threshold(gray: np.ndarray):
    """uint8 (H, W) → ``(threshold, binary)``, as ``cv2.threshold(gray, 0,
    255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)``: the threshold maximises the
    between-class variance over the histogram (float64, OpenCV's order of
    operations, the first maximum kept), and ``binary`` is 255 where
    ``gray > threshold``, else 0."""
    hist = np.bincount(gray.ravel(), minlength=256).astype(np.float64)
    scale = 1.0 / max(gray.size, 1)
    mu = 0.0
    for i in range(256):
        mu += i * hist[i]
    mu *= scale
    eps = float(np.finfo(np.float32).eps)
    mu1 = q1 = 0.0
    max_sigma = max_val = 0.0
    for i in range(256):
        p_i = hist[i] * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < eps or max(q1, q2) > 1.0 - eps:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma = sigma
            max_val = float(i)
    binary = np.where(gray > max_val, 255, 0).astype(np.uint8)
    return max_val, binary


def _linear_taps(src: int, dst: int, inv_scale: float):
    """Source index and float32 weight of each output position of a linear
    resize ``src`` → ``dst`` samples (OpenCV's pixel-centre rule:
    ``f = (d + 0.5)·scale − 0.5`` rounded to float32, ``scale = 1 /
    inv_scale``)."""
    scale = 1.0 / inv_scale
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    return s, f


def _area_taps(dst: int, inv_scale: float):
    """INTER_AREA's taps where it is emulated by the linear machinery (a
    scale below 1 on either axis): ``s = floor(d·scale)`` and ``f = (d + 1) −
    (s + 1)/scale`` in float32, 0 where it is not positive, else its
    fractional part."""
    scale = 1.0 / inv_scale
    d = np.arange(dst)
    s = np.floor(d * scale).astype(np.int64)
    f = ((d + 1) - (s + 1) * inv_scale).astype(np.float32)
    f = np.where(f <= 0, np.float32(0), f - np.floor(f).astype(np.float32))
    return s, f.astype(np.float32)


def _coef(f):
    """float32 weights → OpenCV's ``saturate_cast<short>(w · 2048)``."""
    one = np.float32(1.0)
    return (np.rint((one - f) * np.float32(_COEF_SCALE)).astype(np.int64),
            np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64))


def _two_tap_resize(img: np.ndarray, xtaps, ytaps) -> np.ndarray:
    """OpenCV's fixed-point two-tap resize of uint8 (H, W) or (H, W, C) on
    the given taps: a horizontal pass into integer rows at 11-bit
    coefficients, then a vertical pass that rounds the 22-bit sums back to
    uint8 the way OpenCV's vector loop does. Channels are independent."""
    h, w = img.shape[:2]
    sx, fx = xtaps
    # columns left of the first sample and right of the last take the edge
    # pixel at full weight
    lo = sx < 0
    fx = np.where(lo, np.float32(0), fx)
    sx = np.where(lo, 0, sx)
    hi = sx >= w - 1
    fx = np.where(hi, np.float32(0), fx)
    sx = np.where(hi, w - 1, sx)
    a0, a1 = (a.astype(np.int32) for a in _coef(fx))
    extra = (None,) * (img.ndim - 2)  # broadcast the taps over channels
    cols = (slice(None),) + extra
    a0, a1, hi = a0[cols], a1[cols], hi[cols]
    # int32 holds every sum: rows < 2^20, the vertical products < 2^27
    src = img.astype(np.int32)
    g0 = src[:, sx]
    rows = g0 * a0 + src[:, np.minimum(sx + 1, w - 1)] * a1
    rows = np.where(hi, g0 * _COEF_SCALE, rows)
    # rows: (h, width[, C]) with 11 fractional bits; the vertical taps are
    # not clamped, their rows are
    sy, fy = ytaps
    b0, b1 = (b.astype(np.int32) for b in _coef(fy))
    r0 = rows[np.clip(sy, 0, h - 1)]
    r1 = rows[np.clip(sy + 1, 0, h - 1)]
    b0, b1 = b0[(slice(None), None) + extra], b1[(slice(None), None) + extra]
    # OpenCV's vector loop: 16-bit high products of the rows shifted by 4,
    # a saturating add, then a rounding shift by 2
    v = (((r0 >> 4) * b0) >> 16) + (((r1 >> 4) * b1) >> 16)
    v = (np.clip(v, -32768, 32767) + 2) >> 2
    return np.clip(v, 0, 255).astype(np.uint8)


def _dsize(img, width, height, fx, fy):
    """cv2.resize's output size and inverse scales, from ``dsize`` (width,
    height) or, when it is None, from ``fx, fy`` (the size rounded half to
    even, as ``saturate_cast<int>``)."""
    h, w = img.shape[:2]
    if width is None or height is None:
        if fx is None or fy is None:
            raise ValueError("give width and height, or fx and fy")
        width, height = int(round(w * fx)), int(round(h * fy))
        if width <= 0 or height <= 0:
            raise ValueError(f"empty output size {(height, width)}")
        return width, height, float(fx), float(fy)
    return width, height, width / w, height / h


def resize_linear_u8(img: np.ndarray, width: int = None, height: int = None, *,
                     fx: float = None, fy: float = None) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) → uint8 (height, width[, C]), as
    ``cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)`` or,
    with ``fx, fy`` in place of the size, ``cv2.resize(img, None, fx=fx,
    fy=fy, interpolation=cv2.INTER_LINEAR)`` (upscales; a downscale by
    exactly 2 is INTER_AREA's in OpenCV, not this)."""
    _require_pixels(img, "resize_linear_u8")
    width, height, ix, iy = _dsize(img, width, height, fx, fy)
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return img.copy()
    return _two_tap_resize(img, _linear_taps(w, width, ix), _linear_taps(h, height, iy))


# cv2.INTER_CUBIC: Keys' kernel at A = -0.75, four taps; its uint8 vertical
# pass runs OpenCV's SSE vector loop (8 outputs a step) in float32
_CUBIC_A = -0.75
_CUBIC_LANES = 8


def _cubic_coef(f):
    """float32 fractional offsets → OpenCV's ``interpolateCubic`` weights of
    the taps at −1, 0, +1, +2 (float32, the last one 1 minus the others), as
    ``saturate_cast<short>(w · 2048)``: (n, 4) int64."""
    a, one = np.float32(_CUBIC_A), np.float32(1)
    x = f.astype(np.float32)
    x1 = x + one
    c0 = ((a * x1 - np.float32(5) * a) * x1 + np.float32(8) * a) * x1 - np.float32(4) * a
    c1 = ((a + np.float32(2)) * x - (a + np.float32(3))) * x * x + one
    y = one - x
    c2 = ((a + np.float32(2)) * y - (a + np.float32(3))) * y * y + one
    c3 = one - c0 - c1 - c2
    c = np.stack([c0, c1, c2, c3], axis=-1).astype(np.float32)
    return np.clip(np.rint(c * np.float32(_COEF_SCALE)), -32768, 32767).astype(np.int64)


def resize_cubic_u8(img: np.ndarray, width: int = None, height: int = None, *,
                    fx: float = None, fy: float = None) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) → uint8 (height, width[, C]), as OpenCV's
    own ``cv2.resize(img, (width, height), interpolation=cv2.INTER_CUBIC)``
    (or with ``fx, fy`` in place of the size): half-pixel centres, Keys'
    kernel at A = −0.75 with 11-bit weights, border samples clamped; a
    horizontal pass into integer rows, then a vertical one that OpenCV's
    SSE loop computes in float32 (``S0·b0 + (S1·b1 + (S2·b2 + S3·b3))``
    with ``b = β / 2²²``, rounded half to even) for the first multiple of 8
    values of each row and its scalar code (``(Σ Sβ + 2²¹) >> 22``) for the
    rest. OpenCV builds with Intel IPP route this call to IPP by default,
    whose float sums round some exact .5 ties the other way: this is the
    result with ``cv2.ipp.setUseIPP(False)``."""
    _require_pixels(img, "resize_cubic_u8")
    width, height, ix, iy = _dsize(img, width, height, fx, fy)
    h, w = img.shape[:2]
    sx, fxs = _linear_taps(w, width, ix)
    sy, fys = _linear_taps(h, height, iy)
    a, b = _cubic_coef(fxs), _cubic_coef(fys)
    extra = (None,) * (img.ndim - 2)
    src = img.astype(np.int64)
    rows = 0
    for k in range(4):
        rows = rows + src[:, np.clip(sx + k - 1, 0, w - 1)] * a[(slice(None), k) + extra]
    taps = [rows[np.clip(sy + k - 1, 0, h - 1)] for k in range(4)]
    cols = (slice(None), None) + extra
    exact = sum(t * b[(slice(None), k)][cols] for k, t in enumerate(taps))
    out = (exact + (1 << (2 * _COEF_BITS - 1))) >> (2 * _COEF_BITS)
    beta = (b.astype(np.float32) * np.float32(1.0 / (_COEF_SCALE * _COEF_SCALE)))
    acc = taps[3].astype(np.float32) * beta[(slice(None), 3)][cols]
    for k in (2, 1, 0):
        acc = taps[k].astype(np.float32) * beta[(slice(None), k)][cols] + acc
    vec = np.rint(acc)
    row_len = width * int(np.prod(img.shape[2:], dtype=np.int64))
    n_vec = row_len // _CUBIC_LANES * _CUBIC_LANES
    flat_out = out.reshape(height, row_len)
    flat_out[:, :n_vec] = vec.reshape(height, row_len)[:, :n_vec]
    return np.clip(flat_out, 0, 255).astype(np.uint8).reshape(out.shape)


def equalize_hist_u8(gray: np.ndarray) -> np.ndarray:
    """uint8 (H, W) → ``cv2.equalizeHist(gray)``: with ``i`` the first
    non-empty histogram bin, ``lut[j] = round_half_even(cumsum(hist)[i+1..j]
    · float32(255 / (total − hist[i])))``, ``lut[i] = 0``; a constant image
    maps to itself."""
    _require_pixels(gray, "equalize_hist_u8")
    hist = np.bincount(gray.ravel(), minlength=256).astype(np.int64)
    i = int(np.argmax(hist > 0))
    total = gray.size
    if hist[i] == total:
        return gray.copy()
    scale = np.float32(255.0) / np.float32(total - hist[i])
    cum = np.cumsum(hist) - hist[: i + 1].sum()
    lut = np.clip(np.rint(cum.astype(np.float32) * scale), 0, 255).astype(np.uint8)
    lut[: i + 1] = 0
    return lut[gray]


def gray_to_rgb(gray: np.ndarray) -> np.ndarray:
    """uint8 (H, W) → (H, W, 3), as ``cv2.cvtColor(gray, cv2.COLOR_GRAY2RGB)``."""
    return np.repeat(gray[..., None], 3, axis=-1)


@functools.lru_cache(maxsize=32)
def _area_tab(ssize: int, dsize: int, scale: float):
    """OpenCV's ``computeResizeAreaTab``: each output cell's source samples
    and their float32 weights (the partial first and last ones by the
    covered fraction of the cell), in OpenCV's order. → (index, weight), each
    (dsize, taps), padded with index 0 and weight 0."""
    cells = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        taps = []
        if sx1 - fsx1 > 1e-3:
            taps.append((sx1 - 1, (sx1 - fsx1) / cell))
        taps += [(sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            taps.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        cells.append(taps)
    n = max(len(t) for t in cells)
    index = np.zeros((dsize, n), np.int64)
    weight = np.zeros((dsize, n), np.float32)
    for dx, taps in enumerate(cells):
        for t, (sx, a) in enumerate(taps):
            index[dx, t] = sx
            weight[dx, t] = np.float32(a)
    return index, weight


def _area_general(img, width, height, sx, sy):
    """OpenCV's ``resizeArea_`` (non-integer shrink): each source row's
    horizontal float32 sums (``buf += S·alpha`` in tap order), accumulated
    over the rows of each output row (``sum += beta·buf``), then rounded
    half to even."""
    h, w = img.shape[:2]
    xi, xa = _area_tab(w, width, sx)
    yi, ya = _area_tab(h, height, sy)
    extra = (None,) * (img.ndim - 2)
    src = img.astype(np.float32)
    buf = np.zeros((h, width) + img.shape[2:], np.float32)
    for t in range(xi.shape[1]):  # a zero-weight pad tap adds +0: no change
        buf += src[:, xi[:, t]] * xa[(slice(None), t) + extra]
    acc = np.zeros((height, width) + img.shape[2:], np.float32)
    for t in range(yi.shape[1]):
        acc += ya[(slice(None), t, None) + extra] * buf[yi[:, t]]
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)


def _area_fast(img, width, height, kx, ky):
    """OpenCV's ``ResizeAreaFast`` (an integer shrink ``kx`` × ``ky``): the
    mean of each whole block (2×2 blocks by ``(sum + 2) >> 2``, others by
    ``sum · float32(1/area)`` rounded half to even), and, where the output
    reaches past the last whole block, the float32 mean of the pixels the
    cell does hold."""
    h, w = img.shape[:2]
    c = img.shape[2:]
    src = img.astype(np.int64)
    fw, fh = min(w // kx, width), min(h // ky, height)
    out = np.zeros((height, width) + c, np.uint8)
    blocks = src[:fh * ky, :fw * kx].reshape((fh, ky, fw, kx) + c).sum(axis=(1, 3))
    if kx == 2 and ky == 2:
        out[:fh, :fw] = (blocks + 2) >> 2
    else:
        mean = blocks.astype(np.float32) * (np.float32(1) / np.float32(kx * ky))
        out[:fh, :fw] = np.clip(np.rint(mean), 0, 255)
    for dy in range(height):  # the partial cells, at the right and bottom edges
        xs = range(fw, width) if dy < fh else range(width)
        for dx in xs:
            cell = src[dy * ky:dy * ky + ky, dx * kx:dx * kx + kx]
            n = cell.shape[0] * cell.shape[1]
            mean = cell.sum(axis=(0, 1)).astype(np.float32) / np.float32(n)
            out[dy, dx] = np.clip(np.rint(mean), 0, 255)
    return out


_DBL_EPSILON = float(np.finfo(np.float64).eps)  # OpenCV's test for an integer scale


def resize_area_u8(img: np.ndarray, width: int = None, height: int = None, *,
                   fx: float = None, fy: float = None) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) → uint8 (height, width[, C]), as
    ``cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA)`` or,
    with ``fx, fy`` in place of the size, ``cv2.resize(img, None, fx=fx,
    fy=fy, interpolation=cv2.INTER_AREA)``. OpenCV's three code paths:

    - an integer shrink on both axes: the block mean (:func:`_area_fast`);
    - a shrink on both axes: the area-weighted float32 sums
      (:func:`_area_general`);
    - a scale below 1 on either axis: the linear machinery on INTER_AREA's
      taps (:func:`_area_taps`).
    """
    _require_pixels(img, "resize_area_u8")
    width, height, ix, iy = _dsize(img, width, height, fx, fy)
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return img.copy()
    sx, sy = 1.0 / ix, 1.0 / iy
    if sx >= 1 and sy >= 1:
        kx, ky = int(round(sx)), int(round(sy))
        if abs(sx - kx) < _DBL_EPSILON and abs(sy - ky) < _DBL_EPSILON:
            return _area_fast(img, width, height, kx, ky)
        return _area_general(img, width, height, sx, sy)
    return _two_tap_resize(img, _area_taps(width, ix), _area_taps(height, iy))


def pil_luma(rgb: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) RGB → uint8 (H, W) luma, as Pillow's
    ``Image.convert("L")``: ``(19595·R + 38470·G + 7471·B + 0x8000) >> 16``
    (OpenCV's :func:`rgb_to_gray` rounds otherwise on about 0.1% of
    pixels)."""
    c = rgb.astype(np.int32)
    y = c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471
    return ((y + 0x8000) >> 16).astype(np.uint8)


class PilPixels:
    """The pixels of an RGB PIL image, standing where the JAX package hands
    an engine a PIL crop: ``convert("L")`` is Pillow's luma
    (:func:`pil_luma`, computed once), ``convert("RGB")`` and
    ``np.asarray`` are the pixels. So an engine reads the same bytes of it
    that its JAX counterpart reads of the PIL crop, whichever gray it
    makes."""

    def __init__(self, rgb: np.ndarray):
        self._rgb = rgb
        self._luma = None

    def convert(self, mode: str) -> np.ndarray:
        if mode == "RGB":
            return self._rgb
        if mode == "L":
            if self._luma is None:
                self._luma = pil_luma(self._rgb)
            return self._luma
        raise ValueError(f"PilPixels converts to 'RGB' or 'L', not {mode!r}")

    def __array__(self, dtype=None, copy=None):
        return self._rgb if dtype is None else self._rgb.astype(dtype)


# Pillow's resample.c: 8-bit coefficients in 22-bit fixed point
_PIL_PRECISION_BITS = 32 - 8 - 2


def _pil_bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


@functools.lru_cache(maxsize=32)
def _pil_coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for the
    bicubic filter (support 2, widened by the downscale factor): each output
    sample's first source index and its fixed-point weights. → (first
    (out,), index (out, taps), weight (out, taps) int64, padded with the
    first index and weight 0)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    index = np.zeros((out_size, ksize), np.int64)
    weight = np.zeros((out_size, ksize), np.int64)
    one = 1 << _PIL_PRECISION_BITS
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_pil_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in k:
            ww += v
        if ww != 0.0:
            k = [v / ww for v in k]
        index[xx] = xmin
        index[xx, :xmax] = np.arange(xmin, xmin + xmax)
        weight[xx, :xmax] = [int(-0.5 + v * one) if v < 0 else int(0.5 + v * one)
                             for v in k]
    return index, weight


def _pil_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One of Pillow's 8-bit resample passes along ``axis`` (0 rows, 1
    columns): a rounding-biased fixed-point sum, clipped to uint8."""
    index, weight = _pil_coeffs(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    extra = (None,) * (src.ndim - 1)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PIL_PRECISION_BITS - 1), np.int64)
    for t in range(index.shape[1]):
        acc += src[index[:, t]] * weight[(slice(None), t) + extra]
    out = np.clip(acc >> _PIL_PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_pil_bicubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 (H, W, C) → uint8 (height, width, C), as Pillow's default
    ``Image.fromarray(img).resize((width, height))`` (bicubic, a = −0.5): the
    horizontal pass first, into uint8, then the vertical one; an axis whose
    size does not change is not resampled."""
    _require_pixels(img, "resize_pil_bicubic")
    out = img
    if img.shape[1] != width:
        out = _pil_pass(out, width, 1)
    if img.shape[0] != height:
        out = _pil_pass(out, height, 0)
    return out.copy() if out is img else out


def resize_nearest(x: np.ndarray, factor: int) -> np.ndarray:
    """(h, w) → (h·factor, w·factor), each sample repeated: an exact
    integer-factor ``cv2.resize(..., interpolation=cv2.INTER_NEAREST)``."""
    return np.repeat(np.repeat(x, factor, axis=0), factor, axis=1)


def _cv_nearest_index(src: int, dst: int) -> np.ndarray:
    """OpenCV's ``resizeNN`` sample of each of ``dst`` outputs from ``src``
    inputs: ``min(floor(x · (1 / (dst / src))), src − 1)`` in double (its
    ``ifx = 1./fx`` with ``fx = dsize/ssize``)."""
    ifx = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * ifx).astype(np.int64), src - 1)


def resize_nearest_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W) or (H, W, C) → (height, width[, C]) of the same dtype, as
    ``cv2.resize(img, (width, height), interpolation=cv2.INTER_NEAREST)`` at
    any size: each output takes the source sample at ``floor(x·src/dst)``.
    This is not the half-pixel rule of ``ops.image.resize_nearest`` (JAX's
    ``jax.image.resize``); :func:`resize_nearest` is the integer-factor case."""
    _require_pixels(img, "resize_nearest_u8")
    h, w = img.shape[:2]
    return img[_cv_nearest_index(h, height)][:, _cv_nearest_index(w, width)]


def erode2x2(img: np.ndarray) -> np.ndarray:
    """uint8 (H, W) → ``cv2.erode(img, np.ones((2, 2), np.uint8))``: the
    minimum over each pixel and its up, left and up-left neighbours (the
    kernel's anchor is its (1, 1) cell); cells outside the image are
    ignored."""
    _require_pixels(img, "erode2x2")
    out = img.copy()
    out[1:, :] = np.minimum(out[1:, :], img[:-1, :])
    out[:, 1:] = np.minimum(out[:, 1:], img[:, :-1])
    out[1:, 1:] = np.minimum(out[1:, 1:], img[:-1, :-1])
    return out


def dilate2x2(img: np.ndarray) -> np.ndarray:
    """uint8 (H, W) → ``cv2.dilate(img, np.ones((2, 2), np.uint8))``: the
    maximum over the neighbourhood :func:`erode2x2` takes the minimum of."""
    _require_pixels(img, "dilate2x2")
    out = img.copy()
    out[1:, :] = np.maximum(out[1:, :], img[:-1, :])
    out[:, 1:] = np.maximum(out[:, 1:], img[:, :-1])
    out[1:, 1:] = np.maximum(out[1:, 1:], img[:-1, :-1])
    return out


def _require_f32(x: np.ndarray, what: str) -> np.ndarray:
    x = np.asarray(x)
    if x.dtype != np.float32 or x.ndim != 2 or x.size == 0:
        raise ValueError(f"{what}: a non-empty float32 (H, W) array, got {x.dtype} {x.shape}")
    return x


def resize_area_f32(x: np.ndarray, width: int, height: int) -> np.ndarray:
    """float32 (H, W) → ``cv2.resize(x, (width, height),
    interpolation=cv2.INTER_AREA)`` for a shrink on both axes: a 2×2 integer
    shrink sums each block's rows pairwise, ``((a + b) + (c + d))·0.25``;
    any other shrink takes :func:`_area_general`'s float32 sums, unrounded."""
    x = _require_f32(x, "resize_area_f32")
    h, w = x.shape
    if (h, w) == (height, width):
        return x.copy()
    sx, sy = w / width, h / height
    if sx < 1 or sy < 1:
        raise ValueError("resize_area_f32 ports a shrink on both axes")
    kx, ky = int(round(sx)), int(round(sy))
    if abs(sx - kx) < _DBL_EPSILON and abs(sy - ky) < _DBL_EPSILON:
        if (kx, ky) != (2, 2):
            raise ValueError("resize_area_f32 ports the 2×2 integer shrink only")
        b = x[:height * 2, :width * 2].reshape(height, 2, width, 2)
        return (((b[:, 0, :, 0] + b[:, 0, :, 1]) + (b[:, 1, :, 0] + b[:, 1, :, 1]))
                * np.float32(0.25)).astype(np.float32)
    xi, xa = _area_tab(w, width, sx)
    yi, ya = _area_tab(h, height, sy)
    buf = np.zeros((h, width), np.float32)
    for t in range(xi.shape[1]):
        buf += x[:, xi[:, t]] * xa[:, t]
    acc = np.zeros((height, width), np.float32)
    for t in range(yi.shape[1]):
        acc += ya[:, t, None] * buf[yi[:, t]]
    return acc


def _f32_taps(src: int, dst: int):
    """OpenCV's resize coordinates: ``f = float32((d + 0.5)·scale − 0.5)``,
    ``s = floor(f)``, ``f −= s``."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(np.float32)).astype(np.float32)


def resize_linear_f32(x: np.ndarray, width: int, height: int) -> np.ndarray:
    """float32 (H, W) → ``cv2.resize(x, (width, height),
    interpolation=cv2.INTER_LINEAR)`` as OpenCV's own code computes it
    (``cv2.ipp.setUseIPP(False)``; with IPP on, OpenCV hands float resizes
    to Intel IPP, whose last bits differ): columns clamped to the edge
    pixel at full weight, rows not (their indices are), each pass
    ``S0·w0 + S1·w1`` in float32."""
    x = _require_f32(x, "resize_linear_f32")
    h, w = x.shape
    sx, fx = _f32_taps(w, width)
    lo = sx < 0
    fx, sx = np.where(lo, np.float32(0), fx), np.where(lo, 0, sx)
    hi = sx >= w - 1
    fx, sx = np.where(hi, np.float32(0), fx), np.where(hi, w - 1, sx)
    rows = x[:, sx] * (np.float32(1) - fx) + x[:, np.minimum(sx + 1, w - 1)] * fx
    sy, fy = _f32_taps(h, height)
    r0, r1 = rows[np.clip(sy, 0, h - 1)], rows[np.clip(sy + 1, 0, h - 1)]
    return (r0 * (np.float32(1) - fy)[:, None] + r1 * fy[:, None]).astype(np.float32)


def gaussian_blur3(img: np.ndarray) -> np.ndarray:
    """uint8 (H, W) → ``cv2.GaussianBlur(img, (3, 3), 0.8)``: OpenCV's
    separable fixed-point filter (Q8 taps 61, 134, 61;
    ``host_filter.gaussian_blur_u8``)."""
    from twinvoice_tpu_torch.ops.host_filter import gaussian_blur_u8

    return gaussian_blur_u8(img, 0.8, ksize=3)


def connected_components_stats(binary: np.ndarray):
    """uint8 (H, W), nonzero = foreground → ``(n, labels, stats)`` as
    ``cv2.connectedComponentsWithStats(binary, connectivity=8)`` returns
    them: ``n`` labels counting the background 0, int32 ``labels`` (H, W),
    and int32 ``stats`` (n, 5) rows ``[x, y, w, h, area]``.

    The components are scipy's (8-connected); they are numbered in
    OpenCV's order, the order of each component's first 2×2 block in a
    scan of the image's two-row bands, i.e. of the least ``(y // 2, x)``
    over its pixels."""
    from scipy import ndimage

    fg = np.asarray(binary) != 0
    h, w = fg.shape
    lab, n = ndimage.label(fg, structure=np.ones((3, 3), bool))
    labels = np.zeros((h, w), np.int32)
    stats = np.zeros((n + 1, 5), np.int32)
    if n:
        ys, xs = np.nonzero(fg)
        ls = lab[ys, xs]
        key = (ys // 2).astype(np.int64) * w + xs
        first = np.full(n + 1, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(first, ls, key)
        order = np.argsort(first[1:], kind="stable") + 1
        remap = np.zeros(n + 1, np.int32)
        remap[order] = np.arange(1, n + 1, dtype=np.int32)
        new = remap[ls]
        labels[ys, xs] = new
        x0 = np.full(n + 1, w, np.int64)
        y0 = np.full(n + 1, h, np.int64)
        x1 = np.full(n + 1, -1, np.int64)
        y1 = np.full(n + 1, -1, np.int64)
        np.minimum.at(x0, new, xs)
        np.minimum.at(y0, new, ys)
        np.maximum.at(x1, new, xs)
        np.maximum.at(y1, new, ys)
        area = np.bincount(new, minlength=n + 1)
        stats[1:] = np.stack([x0[1:], y0[1:], (x1 - x0 + 1)[1:],
                              (y1 - y0 + 1)[1:], area[1:]], axis=1)
    stats[0] = _background_stats(~fg)
    return n + 1, labels, stats


def _background_stats(bg: np.ndarray):
    ys, xs = np.nonzero(bg)
    if ys.size == 0:  # no background pixel: OpenCV's row for an empty label
        return [-1, np.iinfo(np.int32).max, 0, 0, 0]
    return [xs.min(), ys.min(), xs.max() - xs.min() + 1,
            ys.max() - ys.min() + 1, ys.size]


def _reflect101_index(p: np.ndarray, n: int) -> np.ndarray:
    """OpenCV's ``borderInterpolate(p, n, BORDER_REFLECT_101)`` of each index
    ``p`` (reflected as often as it takes; any index maps to 0 when ``n`` is
    1)."""
    p = np.asarray(p, np.int64)
    if n == 1:
        return np.zeros_like(p)
    period = 2 * (n - 1)
    p = np.mod(p, period)
    return np.where(p < n, p, period - p)


def _pad_reflect101(img: np.ndarray, top: int, bottom: int, left: int,
                    right: int) -> np.ndarray:
    """``cv2.copyMakeBorder(img, top, bottom, left, right,
    cv2.BORDER_REFLECT_101)`` of a 2-D array."""
    h, w = img.shape
    rows = _reflect101_index(np.arange(-top, h + bottom), h)
    cols = _reflect101_index(np.arange(-left, w + right), w)
    return img[rows][:, cols]


def filter2d_3x3_u8(gray: np.ndarray, kernel) -> np.ndarray:
    """uint8 (H, W) → ``cv2.filter2D(gray, -1, kernel)`` for a 3×3 kernel of
    whole numbers (such as the sharpen kernel ``[[-1,-1,-1],[-1,9,-1],
    [-1,-1,-1]]``): the correlation at the kernel's centre over
    ``BORDER_REFLECT_101`` edges, saturated to uint8. OpenCV sums in float32;
    with whole-number taps and uint8 pixels every partial sum is an exact
    integer, so the integer sum here is its result."""
    _require_pixels(gray, "filter2d_3x3_u8")
    k = np.asarray(kernel, np.float64)
    if k.shape != (3, 3) or not np.array_equal(k, np.round(k)):
        raise ValueError(f"a 3×3 kernel of whole numbers, got {k.tolist()}")
    k = k.astype(np.int64)
    h, w = gray.shape
    p = _pad_reflect101(gray.astype(np.int64), 1, 1, 1, 1)
    acc = np.zeros((h, w), np.int64)
    for dy in range(3):
        for dx in range(3):
            if k[dy, dx]:
                acc += k[dy, dx] * p[dy:dy + h, dx:dx + w]
    return np.clip(acc, 0, 255).astype(np.uint8)


def clahe_u8(gray: np.ndarray, clip_limit: float = 40.0, tiles=(8, 8)) -> np.ndarray:
    """uint8 (H, W) → ``cv2.createCLAHE(clipLimit=clip_limit,
    tileGridSize=tiles).apply(gray)``, OpenCV's own code:

    - a size that the tile grid (``tiles`` = (across, down)) does not divide
      is padded on the right and bottom by ``BORDER_REFLECT_101``, each axis
      by ``tiles − size % tiles`` (a whole tile on an axis that divides, when
      the other does not); the histograms are the padded image's tiles;
    - each tile's histogram is clipped at ``max(int(clip·area/256), 1)``, the
      excess spread evenly over the 256 bins and its remainder one a bin
      from bin 0 in steps of ``max(256 // remainder, 1)``;
    - its LUT is ``saturate_cast<uchar>(cumsum · float32(255/area))``;
    - each pixel blends the LUTs of the four nearest tile centres
      bilinearly in float32, in OpenCV's order of operations, and is rounded
      half to even.
    """
    _require_pixels(gray, "clahe_u8")
    tx, ty = int(tiles[0]), int(tiles[1])
    h, w = gray.shape
    src = gray
    if w % tx or h % ty:
        src = _pad_reflect101(gray, 0, ty - h % ty, 0, tx - w % tx)
    tw, th = src.shape[1] // tx, src.shape[0] // ty
    area = tw * th
    clip = max(int(clip_limit * area / 256), 1) if clip_limit > 0 else 0
    # (ty, tx, 256) histograms of the tiles
    tile_ids = (np.arange(src.shape[0])[:, None] // th) * tx + np.arange(src.shape[1])[None] // tw
    hist = np.bincount((tile_ids.astype(np.int64) * 256 + src).ravel(),
                       minlength=tx * ty * 256).reshape(tx * ty, 256)
    if clip:
        clipped = np.maximum(hist - clip, 0).sum(axis=1)
        hist = np.minimum(hist, clip) + (clipped // 256)[:, None]
        residual = clipped % 256
        for t in np.nonzero(residual)[0]:
            r = int(residual[t])
            step = max(256 // r, 1)
            hist[t, np.arange(0, 256, step)[:r]] += 1
    scale = np.float32(255.0) / np.float32(area)
    lut = np.clip(np.rint(np.cumsum(hist, axis=1).astype(np.float32) * scale), 0, 255)
    lut = lut.astype(np.uint8).reshape(ty, tx, 256).astype(np.float32)

    def _axis(n, tile, count):
        f = np.arange(n, dtype=np.float32) * (np.float32(1.0) / np.float32(tile)) \
            - np.float32(0.5)
        i1 = np.floor(f).astype(np.int64)
        a = (f - i1.astype(np.float32)).astype(np.float32)
        return (np.maximum(i1, 0), np.minimum(i1 + 1, count - 1), a,
                (np.float32(1.0) - a).astype(np.float32))

    x1, x2, xa, xa1 = _axis(w, tw, tx)
    y1, y2, ya, ya1 = _axis(h, th, ty)
    v = gray.astype(np.int64)
    r1, r2 = y1[:, None], y2[:, None]
    l11, l12 = lut[r1, x1[None], v], lut[r1, x2[None], v]
    l21, l22 = lut[r2, x1[None], v], lut[r2, x2[None], v]
    top = l11 * xa1[None] + l12 * xa[None]
    bottom = l21 * xa1[None] + l22 * xa[None]
    res = top * ya1[:, None] + bottom * ya[:, None]
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)


# cv2.COLOR_RGB2YCrCb / COLOR_YCrCb2RGB on uint8: 14-bit fixed point
_YUV_SHIFT = 14
_Y_R, _Y_G, _Y_B, _CR, _CB = 4899, 9617, 1868, 11682, 9241
_CR2R, _CR2G, _CB2G, _CB2B = 22987, -11698, -5636, 29049


def _descale(x, n=_YUV_SHIFT):
    return (x + (1 << (n - 1))) >> n


def rgb_to_ycrcb_u8(rgb: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) RGB → uint8 (H, W, 3) Y, Cr, Cb, as
    ``cv2.cvtColor(rgb, cv2.COLOR_RGB2YCrCb)``: ``Y = (4899·R + 9617·G +
    1868·B + 2¹³) >> 14``, ``Cr = ((R − Y)·11682 + 128·2¹⁴ + 2¹³) >> 14``,
    ``Cb = ((B − Y)·9241 + 128·2¹⁴ + 2¹³) >> 14``, saturated."""
    c = rgb.astype(np.int64)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    y = _descale(r * _Y_R + g * _Y_G + b * _Y_B)
    delta = 128 << _YUV_SHIFT
    cr = _descale((r - y) * _CR + delta)
    cb = _descale((b - y) * _CB + delta)
    return np.clip(np.stack([y, cr, cb], axis=-1), 0, 255).astype(np.uint8)


def ycrcb_to_rgb_u8(ycrcb: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) Y, Cr, Cb → uint8 (H, W, 3) RGB, as
    ``cv2.cvtColor(ycrcb, cv2.COLOR_YCrCb2RGB)``: ``R = Y + ((Cr − 128)·22987
    + 2¹³) >> 14``, ``G = Y + ((Cb − 128)·−5636 + (Cr − 128)·−11698 + 2¹³) >>
    14``, ``B = Y + ((Cb − 128)·29049 + 2¹³) >> 14``, saturated."""
    c = ycrcb.astype(np.int64)
    y, cr, cb = c[..., 0], c[..., 1] - 128, c[..., 2] - 128
    r = y + _descale(cr * _CR2R)
    g = y + _descale(cb * _CB2G + cr * _CR2G)
    b = y + _descale(cb * _CB2B)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)
