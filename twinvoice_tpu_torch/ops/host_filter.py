"""Gaussian blurs, 2-D filters and the cubic resize of float32 fields, in
numpy, as OpenCV 5 computes them for the perturbation engine
(``data/augment.py``).

- :func:`gaussian_blur_u8`: ``cv2.GaussianBlur(img, (k, k), sigma)`` on
  uint8, byte for byte. OpenCV's 8-bit path is its bit-exact fixed-point
  filter: ksize ``k`` or ``cvRound(6σ + 1) | 1``, the kernel of
  ``getGaussianKernelBitExact`` turned into Q8 taps by error diffusion
  (``getGaussianKernelFixedPoint_ED``: each outer tap rounded with the
  error carried inward, the centre tap the rest of 256), a horizontal pass
  kept exact in 16 bits, a vertical one rounded half up from 16 fractional
  bits, ``BORDER_REFLECT_101`` edges.
- :func:`gaussian_blur_f32`: the same call on float32 (H, W[, C]): ksize
  ``cvRound(8σ + 1) | 1``, the bit-exact kernel rounded to float32, rows
  (an FMA chain tap by tap; at 3 or 5 taps the inner pair summed first,
  then the centre, then the outer pair) then columns (the centre, then
  each symmetric pair summed first),
  ``BORDER_REFLECT_101``.
- :func:`filter2d_f32`: ``cv2.filter2D(x, -1, k)`` on float32 with an odd
  square kernel of side 3 to 13: the correlation at the kernel's centre over
  ``BORDER_REFLECT_101`` edges. OpenCV sums a kernel of fewer than 130 taps
  directly (one float32 FMA a nonzero tap) and switches a larger one
  (13×13 = 169) to its DFT path; the port sums directly at every size,
  which is OpenCV's result below 130 taps and within a few ulp of its DFT.
- The perturbation engine also blurs and filters float64 fields (numpy
  promotes its float32 image where a float64 scalar multiplies it); both
  functions then compute in float64, as OpenCV does for ``CV_64F``.
- :func:`resize_cubic_f32`: ``cv2.resize(x, (w, h),
  interpolation=cv2.INTER_CUBIC)`` on float32: half-pixel centres, the
  a = −0.75 kernel, replicated edges, horizontal then vertical (IPP's
  arithmetic, as near as float64 weights come to it).
- :func:`resize_cubic_f32_cv`: the same call bit for bit as OpenCV's own
  code computes it (``cv2.ipp.setUseIPP(False)``), for ``render_line``'s
  elastic field, whose port holds JAX's lines byte for byte.

The float32 functions are held to ``cv2`` within the tolerances that
``tests/test_torch_filter.py`` states (OpenCV's own order of float32 sums
differs by a few ulp, and the DFT path by more).
"""

from __future__ import annotations

import math

import numpy as np

from twinvoice_tpu_torch.ops.host_image import _reflect101_index, _require_pixels

_F32 = np.float32


def gaussian_kernel_bitexact(n: int, sigma: float):
    """``getGaussianKernelBitExact(n, sigma)`` for ``sigma`` > 0 and odd
    ``n``: → n float64 taps that sum to about 1."""
    if n < 1 or n % 2 == 0 or sigma <= 0:
        raise ValueError(f"an odd size and sigma > 0, got {n}, {sigma}")
    scale2 = -0.125 / (float(sigma) * float(sigma))
    half = (n - 1) // 2
    values, total = [], 0.0
    x = 1 - n
    for _ in range(half):
        t = math.exp(float(x * x) * scale2)
        values.append(t)
        total += t
        x += 2
    total = total * 2.0 + 1.0
    mul = 1.0 / total
    taps = [0.0] * n
    for i, v in enumerate(values):
        taps[i] = taps[n - 1 - i] = v * mul
    taps[half] = mul
    return taps


def gaussian_taps_q8(n: int, sigma: float) -> np.ndarray:
    """``getGaussianKernelFixedPoint_ED`` with 8 fraction bits: → int64 Q8
    taps summing to 256."""
    taps = gaussian_kernel_bitexact(n, sigma)
    out = np.zeros(n, np.int64)
    err, total = 0.0, 0
    for i in range(n // 2):
        adj = taps[i] * 256.0 + err
        v = int(np.rint(adj))
        err = adj - v
        out[i] = out[n - 1 - i] = v
        total += v
    out[n // 2] = 256 - 2 * total
    return out


def _pad101(x: np.ndarray, r: int, axis: int) -> np.ndarray:
    idx = _reflect101_index(np.arange(-r, x.shape[axis] + r), x.shape[axis])
    return np.take(x, idx, axis=axis)


def _madd(x, k, acc):
    """``x·k + acc`` summed in float64 and rounded once to ``acc``'s dtype:
    for float32 an FMA up to a double rounding at an exact float32
    midpoint."""
    return (x.astype(np.float64) * float(k) + acc).astype(acc.dtype)


def _separable_q8(x: np.ndarray, taps) -> np.ndarray:
    """Rows then columns with integer ``taps`` (reflect-101 edges), exact."""
    n = len(taps)
    r = n // 2
    h, w = x.shape[:2]
    p = _pad101(x, r, 1)
    hs = sum(int(taps[j]) * p[:, j:j + w] for j in range(n))
    q = _pad101(hs, r, 0)
    return sum(int(taps[i]) * q[i:i + h] for i in range(n))


def gaussian_blur_u8(img: np.ndarray, sigma: float, ksize: int = 0) -> np.ndarray:
    """uint8 (H, W[, C]) → ``cv2.GaussianBlur(img, (ksize, ksize), sigma)``
    (``ksize`` 0: from sigma), byte for byte (see the module docstring)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"a uint8 image, got {img.dtype}")
    _require_pixels(img, "gaussian_blur_u8")
    n = int(ksize) or int(np.rint(float(sigma) * 6 + 1)) | 1
    vs = _separable_q8(img.astype(np.int64), gaussian_taps_q8(n, sigma))
    return np.clip((vs + (1 << 15)) >> 16, 0, 255).astype(np.uint8)


def _row_tail(rows: np.ndarray, p: np.ndarray, taps) -> np.ndarray:
    """The last ``(W·C) % 8`` values of each float32 row, which OpenCV's row
    filter computes after its 8-lane loop in scalar code without FMAs:
    ``k0·S0 + k1·(S−1 + S1) [+ k2·(S−2 + S2)]`` at 3 or 5 taps, else the
    taps' products added one after another."""
    h, w = rows.shape[:2]
    flat = rows.reshape(h, -1)
    tail = flat.shape[1] % 8
    if not tail:
        return rows
    n = len(taps)
    r = n // 2
    cn = flat.shape[1] // w
    pf = p.reshape(h, -1)
    start = flat.shape[1] - tail

    def S(k):  # the padded row's values k pixels from each tail value
        return pf[:, start + (r + k) * cn:start + (r + k) * cn + tail]

    if n <= 5:
        acc = taps[r] * S(0)
        for k in range(1, r + 1):
            acc = acc + taps[r + k] * (S(-k) + S(k))
    else:
        acc = taps[0] * S(-r)
        for j in range(1, n):
            acc = acc + taps[j] * S(j - r)
    out = flat.copy()
    out[:, start:] = acc
    return out.reshape(rows.shape)


def _column_tail(out: np.ndarray, q: np.ndarray, taps) -> np.ndarray:
    """The last ``(W·C) % 8`` values of each float32 output row, which the
    column filter computes after its vector loop without FMAs:
    ``k0·S0``, then ``+ k·(S−k + Sk)`` for each pair."""
    h = out.shape[0]
    flat = out.reshape(h, -1)
    tail = flat.shape[1] % 8
    if not tail:
        return out
    r = len(taps) // 2
    qf = q.reshape(q.shape[0], -1)[:, -tail:]
    acc = taps[r] * qf[r:r + h]
    for k in range(1, r + 1):
        acc = acc + taps[r + k] * (qf[r + k:r + k + h] + qf[r - k:r - k + h])
    flat = flat.copy()
    flat[:, -tail:] = acc
    return flat.reshape(out.shape)


def gaussian_blur_f32(x: np.ndarray, sigma: float) -> np.ndarray:
    """float32 (H, W[, C]) → ``cv2.GaussianBlur(x, (0, 0), sigma)`` within a
    few float32 ulp. A float64 array is blurred in float64 with the float64
    taps, as OpenCV blurs ``CV_64F``."""
    x = np.asarray(x)
    if x.dtype not in (np.float32, np.float64) or x.size == 0:
        raise ValueError(f"a non-empty float32 or float64 array, got {x.dtype} {x.shape}")
    n = int(np.rint(float(sigma) * 8 + 1)) | 1
    taps = np.asarray(gaussian_kernel_bitexact(n, sigma), np.float64).astype(x.dtype)
    r = n // 2
    h, w = x.shape[:2]
    p = _pad101(x, r, 1)
    if n == 1:
        rows = _madd(x, taps[0], np.zeros(x.shape, x.dtype))
    elif n <= 5:
        # 3 or 5 taps: SymmRowSmallVec_32f, the inner pair (summed first)
        # times its tap, then an FMA of the centre, then of the outer pair
        pair = lambda k: p[:, r + k:r + k + w] + p[:, r - k:r - k + w]  # noqa: E731
        rows = _madd(pair(1), taps[r + 1], np.zeros(x.shape, x.dtype))
        rows = _madd(p[:, r:r + w], taps[r], rows)
        if n == 5:
            rows = _madd(pair(2), taps[r + 2], rows)
    else:
        # wider rows: RowVec_32f's FMA chain from zero, tap by tap
        rows = np.zeros(x.shape, x.dtype)
        for j in range(n):
            rows = _madd(p[:, j:j + w], taps[j], rows)
    if x.dtype == _F32:
        rows = _row_tail(rows, p, taps)
    # columns: SymmColumnVec_32f, the centre tap, then each symmetric pair
    # summed before its FMA
    q = _pad101(rows, r, 0)
    out = _madd(q[r:r + h], taps[r], np.zeros(x.shape, x.dtype))
    for k in range(1, r + 1):
        out = _madd(q[r + k:r + k + h] + q[r - k:r - k + h], taps[r + k], out)
    if x.dtype == _F32:
        out = _column_tail(out, q, taps)
    return out


def filter2d_f32(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """float32 (H, W[, C]) and an odd square float32 kernel of side 3 to 13
    → ``cv2.filter2D(x, -1, k)`` (see the module docstring): the nonzero
    taps in row-major order, each one FMA onto a float32 sum from zero, as
    ``FilterVec_32f`` adds them. A float64 array is filtered in float64."""
    x = np.asarray(x)
    k = np.asarray(k)
    if x.dtype not in (np.float32, np.float64) or x.size == 0:
        raise ValueError(f"a non-empty float32 or float64 array, got {x.dtype} {x.shape}")
    if k.ndim != 2 or k.shape[0] != k.shape[1] or k.shape[0] % 2 == 0 or not 3 <= k.shape[0] <= 13:
        raise ValueError(f"an odd square kernel of side 3..13, got {k.shape}")
    n = k.shape[0]
    r = n // 2
    h, w = x.shape[:2]
    p = _pad101(_pad101(x, r, 0), r, 1)
    acc = np.zeros(x.shape, x.dtype)
    for i in range(n):
        for j in range(n):
            if k[i, j] != 0:
                acc = _madd(p[i:i + h, j:j + w], k[i, j], acc)
    return acc


def _cubic_taps(dst: int, src: int):
    """Source index and four float64 weights of each output along an axis:
    ``fx = (d + 0.5)·(1/(dst/src)) − 0.5``, ``sx = floor(fx)``, the
    a = −0.75 kernel at ``fx − sx``, all in float64; indices replicated at
    the edges."""
    scale = 1.0 / (dst / src)
    f = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    s = np.floor(f)
    t = f - s
    a = -0.75
    w0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    w1 = ((a + 2) * t - (a + 3)) * t * t + 1
    w2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
    w3 = 1 - w0 - w1 - w2
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3)[None, :], 0, src - 1)
    return idx, np.stack([w0, w1, w2, w3], 1)


def resize_cubic_f32(x: np.ndarray, width: int, height: int) -> np.ndarray:
    """float32 (h, w) → (height, width), ``cv2.resize(x, (width, height),
    interpolation=cv2.INTER_CUBIC)`` within a few float32 ulp: OpenCV's
    default build routes it through Intel IPP, whose result is closest to
    coordinates and weights in float64, each row's horizontal sum rounded
    to float32 and the vertical sum taken in float64."""
    x = np.asarray(x)
    if x.dtype != _F32 or x.ndim != 2 or x.size == 0:
        raise ValueError(f"a non-empty float32 (h, w) array, got {x.dtype} {x.shape}")
    xi, xw = _cubic_taps(int(width), x.shape[1])
    yi, yw = _cubic_taps(int(height), x.shape[0])
    x64 = x.astype(np.float64)
    rows = sum(x64[:, xi[:, k]] * xw[:, k] for k in range(4)).astype(_F32).astype(np.float64)
    return sum(rows[yi[:, k]] * yw[:, k][:, None] for k in range(4)).astype(_F32)


def _cubic_coeffs_f32(t: np.ndarray):
    """OpenCV's ``interpolateCubic`` (A = −0.75) in float32."""
    A, one = _F32(-0.75), _F32(1)
    t = t.astype(_F32)
    c0 = ((A * (t + one) - _F32(5) * A) * (t + one) + _F32(8) * A) * (t + one) - _F32(4) * A
    c1 = ((A + _F32(2)) * t - (A + _F32(3))) * t * t + one
    c2 = ((A + _F32(2)) * (one - t) - (A + _F32(3))) * (one - t) * (one - t) + one
    c3 = one - c0 - c1 - c2
    return [c.astype(_F32) for c in (c0, c1, c2, c3)]


def resize_cubic_f32_cv(x: np.ndarray, width: int, height: int) -> np.ndarray:
    """float32 (h, w) → (height, width), ``cv2.resize(x, (width, height),
    interpolation=cv2.INTER_CUBIC)`` bit for bit as OpenCV's own code
    computes it (``cv2.ipp.setUseIPP(False)``): float32 coordinates and
    weights, each row's four taps summed left to right with replicated edge
    indices, the vertical taps as ``S0·b0 + (S1·b1 + (S2·b2 + S3·b3))``."""
    x = np.asarray(x)
    if x.dtype != _F32 or x.ndim != 2 or x.size == 0:
        raise ValueError(f"a non-empty float32 (h, w) array, got {x.dtype} {x.shape}")
    h, w = x.shape

    def taps(src, dst):
        scale = 1.0 / (dst / src)
        f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(_F32)
        s = np.floor(f).astype(np.int64)
        return s, _cubic_coeffs_f32((f - s.astype(_F32)).astype(_F32))

    sx, ax = taps(w, int(width))
    rows = x[:, np.clip(sx - 1, 0, w - 1)] * ax[0]
    for k in range(1, 4):
        rows = rows + x[:, np.clip(sx - 1 + k, 0, w - 1)] * ax[k]
    sy, by = taps(h, int(height))
    r = [rows[np.clip(sy - 1 + k, 0, h - 1)] * by[k][:, None] for k in range(4)]
    return (r[0] + (r[1] + (r[2] + r[3]))).astype(_F32)
