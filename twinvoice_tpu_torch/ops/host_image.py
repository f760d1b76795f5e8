"""Host image steps of the recognition stack in numpy, for a machine without
OpenCV.

The JAX package's recognizer and detector call OpenCV on the host
(``ocr/jaxocr/engine.py``, ``detector.py``, ``textness.py``). Each function
here computes what that call computes on uint8 (or float32) arrays, with
OpenCV's own fixed-point arithmetic where it has one, so the strings and boxes
the port reads are the JAX package's. ``tests/test_torch_host_image.py``
holds each against ``cv2`` on seeded sweeps.
"""

from __future__ import annotations

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


def _linear_taps(src: int, dst: int):
    """Source index and 11-bit coefficient pair of each output position of
    a linear resize ``src`` → ``dst`` samples (OpenCV's pixel-centre rule:
    ``f = (d + 0.5)·src/dst − 0.5`` rounded to float32)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    return s, f


def _coef(f):
    """float32 weights → OpenCV's ``saturate_cast<short>(w · 2048)``."""
    one = np.float32(1.0)
    return (np.rint((one - f) * np.float32(_COEF_SCALE)).astype(np.int64),
            np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64))


def resize_linear_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 (H, W) → uint8 (height, width), as ``cv2.resize(img, (width,
    height), interpolation=cv2.INTER_LINEAR)``: a horizontal pass into
    integer rows at 11-bit coefficients, then a vertical pass that rounds
    the 22-bit sums back to uint8 the way OpenCV's vector loop does."""
    _require_pixels(img, "resize_linear_u8")
    h, w = img.shape
    if (h, w) == (height, width):
        return img.copy()
    sx, fx = _linear_taps(w, width)
    # columns left of the first sample and right of the last take the edge
    # pixel at full weight
    lo = sx < 0
    fx = np.where(lo, np.float32(0), fx)
    sx = np.where(lo, 0, sx)
    hi = sx >= w - 1
    fx = np.where(hi, np.float32(0), fx)
    sx = np.where(hi, w - 1, sx)
    a0, a1 = _coef(fx)
    src = img.astype(np.int64)
    rows = src[:, sx] * a0 + src[:, np.minimum(sx + 1, w - 1)] * a1
    rows = np.where(hi, src[:, sx] * _COEF_SCALE, rows)
    # rows: (h, width) with 11 fractional bits; the vertical taps are not
    # clamped, their rows are
    sy, fy = _linear_taps(h, height)
    b0, b1 = _coef(fy)
    r0 = rows[np.clip(sy, 0, h - 1)]
    r1 = rows[np.clip(sy + 1, 0, h - 1)]
    b0, b1 = b0[:, None], b1[:, None]
    # OpenCV's vector loop: 16-bit high products of the rows shifted by 4,
    # a saturating add, then a rounding shift by 2
    v = (((r0 >> 4) * b0) >> 16) + (((r1 >> 4) * b1) >> 16)
    v = (np.clip(v, -32768, 32767) + 2) >> 2
    return np.clip(v, 0, 255).astype(np.uint8)


def resize_nearest(x: np.ndarray, factor: int) -> np.ndarray:
    """(h, w) → (h·factor, w·factor), each sample repeated: an exact
    integer-factor ``cv2.resize(..., interpolation=cv2.INTER_NEAREST)``."""
    return np.repeat(np.repeat(x, factor, axis=0), factor, axis=1)


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
