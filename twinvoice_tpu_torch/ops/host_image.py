"""Host image steps in numpy, for a machine without OpenCV or Pillow.

The JAX package calls OpenCV and Pillow on the host: the recognizer and
detector (``ocr/jaxocr/engine.py``, ``detector.py``, ``textness.py``), the
segmenter's host resize (``infer/pipeline.py``) and the QR scan
(``qr/detect.py``). Each function here computes what that call computes on
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
    a0, a1 = _coef(fx)
    extra = (None,) * (img.ndim - 2)  # broadcast the taps over channels
    cols = (slice(None),) + extra
    a0, a1, hi = a0[cols], a1[cols], hi[cols]
    src = img.astype(np.int64)
    rows = src[:, sx] * a0 + src[:, np.minimum(sx + 1, w - 1)] * a1
    rows = np.where(hi, src[:, sx] * _COEF_SCALE, rows)
    # rows: (h, width[, C]) with 11 fractional bits; the vertical taps are
    # not clamped, their rows are
    sy, fy = ytaps
    b0, b1 = _coef(fy)
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


# cv2.GaussianBlur's bit-exact 8-bit kernel for ksize 3, sigma 0.8: Q8
# fixed-point taps summing to 256
_GAUSS3_08 = (61, 134, 61)


def gaussian_blur3(img: np.ndarray) -> np.ndarray:
    """uint8 (H, W) → ``cv2.GaussianBlur(img, (3, 3), 0.8)``: OpenCV's
    separable fixed-point filter (Q8 taps, the horizontal sums kept in 16
    bits, the 2-D sum rounded half up from 16 fractional bits) with
    ``BORDER_REFLECT_101`` edges."""
    _require_pixels(img, "gaussian_blur3")
    k0, k1, k2 = _GAUSS3_08
    x = img.astype(np.int64)
    h, w = x.shape
    if w > 1:
        p = np.pad(x, ((0, 0), (1, 1)), mode="reflect")
    else:
        p = np.pad(x, ((0, 0), (1, 1)), mode="edge")
    hs = p[:, :-2] * k0 + p[:, 1:-1] * k1 + p[:, 2:] * k2
    if h > 1:
        q = np.pad(hs, ((1, 1), (0, 0)), mode="reflect")
    else:
        q = np.pad(hs, ((1, 1), (0, 0)), mode="edge")
    vs = q[:-2] * k0 + q[1:-1] * k1 + q[2:] * k2
    return np.clip((vs + (1 << 15)) >> 16, 0, 255).astype(np.uint8)


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
