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
  square kernel of side 3 to 13, by OpenCV's route for the kernel's area
  (``dftFilter2D``): below 130 taps (float64: 50) the correlation at the
  kernel's centre over ``BORDER_REFLECT_101`` edges, the nonzero taps one
  FMA each onto a sum from zero (``FilterVec_32f``), the last ``(W·C) % 8``
  values of a row without FMAs; from 130 taps (float64: from 50) its DFT
  path, ``crossCorr``, which computes in double for either depth (tiles of
  ``getOptimalDFTSize`` blocks, the real 2-D DFT, ``mulSpectrums`` with the
  kernel's conjugate spectrum, the scaled inverse) and rounds once to the
  image's depth. The DFT is the host C++ library ``csrc/host_dft.cpp``
  (:func:`dft_library`, built by ``_build.build_host`` at first use):
  numpy's FFT rounds in another order than OpenCV's mixed-radix
  butterflies and its twiddle table. On the engine's odd square kernels
  that is float32 at 13×13 and float64 at 9×9 to 13×13.
- The perturbation engine also blurs and filters float64 fields (numpy
  promotes its float32 image where a float64 scalar multiplies it); both
  functions then compute in float64, as OpenCV does for ``CV_64F``.
- :func:`resize_cubic_f32`: ``cv2.resize(x, (w, h),
  interpolation=cv2.INTER_CUBIC)`` on float32 bit for bit as OpenCV's own
  code computes it (``cv2.ipp.setUseIPP(False)``; with IPP, which the
  wheel uses by default, the last bits differ).

The float32 functions follow OpenCV 5.0's code as it runs on an x86-64
CPU with AVX2 and FMA3: its vector loops fuse each multiply-add, its scalar
tails do not (but where its compiler fused them). ``tests/test_torch_filter.py`` holds them to ``cv2`` with IPP off,
byte for byte at the perturbation engine's shapes.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from decimal import Decimal, getcontext
from pathlib import Path

import numpy as np

from twinvoice_tpu_torch import _build
from twinvoice_tpu_torch.ops.host_image import _reflect101_index, _require_pixels

_F32 = np.float32
DFT_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host_dft.cpp"
# dftFilter2D: a kernel of at least this many taps takes OpenCV's DFT path
DFT_MIN_TAPS = {np.dtype(np.float32): 130, np.dtype(np.float64): 50}

_lock = threading.Lock()
_dft = None


def build_dft() -> Path:
    """Compile the DFT library unless it is built already. → its path."""
    return _build.build_host(DFT_SOURCE, "hostdft", "DFT filter")


def dft_library() -> ctypes.CDLL:
    """The loaded DFT library (``csrc/host_dft.cpp``), built first if need be."""
    global _dft
    with _lock:
        if _dft is None:
            lib = ctypes.CDLL(str(build_dft()))
            p, i32 = ctypes.c_void_p, ctypes.c_int
            lib.host_dft_complex.argtypes = [i32, i32, ctypes.c_double, p, p]
            lib.host_dft_real2d.argtypes = [i32, i32, i32, i32, p]
            lib.host_dft_filter2d.argtypes = [p, i32, i32, i32, p, i32, i32, p]
            for f in (lib.host_dft_complex, lib.host_dft_real2d, lib.host_dft_filter2d):
                f.restype = i32
            _dft = lib
        return _dft


def dft_filter2d(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """OpenCV's DFT path of ``filter2D`` (``crossCorr``): ``x`` float32 or
    float64 (H, W[, C]), ``k`` a 2-D kernel (rounded to float32 for a
    float32 image, as ``crossCorr`` converts it) → the correlation at the
    kernel's centre over ``BORDER_REFLECT_101`` edges, computed in double
    and rounded to ``x``'s depth."""
    src = np.ascontiguousarray(x, np.float64)
    ker = np.asarray(k)
    if x.dtype == _F32:
        ker = ker.astype(_F32)
    ker = np.ascontiguousarray(ker, np.float64)
    out = np.empty_like(src)
    cn = 1 if x.ndim == 2 else x.shape[2]
    rc = dft_library().host_dft_filter2d(src.ctypes.data, x.shape[0], x.shape[1], cn,
                                         ker.ctypes.data, ker.shape[0], ker.shape[1],
                                         out.ctypes.data)
    if rc != 0:
        raise ValueError(f"DFT filter refused {x.shape} with a {ker.shape} kernel")
    return out.astype(x.dtype)


# cv::softdouble exp (OpenCV's softfloat.cpp): a 64-entry table of
# 2^(i/64) and a degree-5 polynomial, all in IEEE double without FMAs
_EXP_A0 = 0.9670371139572337719125840413672004409288e-2
_EXP_POLY = tuple(c / _EXP_A0 for c in (
    .13369713757180123244806654839424e-2, .96180973140732918010002372686186e-2,
    .55504108793649567998466049042729e-1, .24022650695886477918181338054308,
    .69314718055994546743029643825322, .99999999999999999998285227504999))
_EXP_PRESCALE = struct.unpack("<d", struct.pack("<Q", 0x3FF71547652B82FE))[0] * 64.0


def _exp_table():
    getcontext().prec = 60
    return [float(Decimal(2) ** (Decimal(i) / Decimal(64))) * _EXP_A0 for i in range(64)]


_EXP_TAB = _exp_table()


def soft_exp(x: float) -> float:
    """OpenCV's ``softdouble`` ``exp(x)`` for finite ``x`` of moderate size
    (the Gaussian kernels' exponents), which differs from the C library's
    by a few ulp."""
    x0 = float(x) * _EXP_PRESCALE
    val0 = int(np.rint(x0))
    t = min(max((val0 >> 6) + 1023, 0), 2047)
    scale = struct.unpack("<d", struct.pack("<Q", t << 52))[0]
    x0 = (x0 - float(np.rint(x0))) / 64.0
    poly = _EXP_POLY[0]
    for c in _EXP_POLY[1:]:
        poly = poly * x0 + c
    return scale * poly * _EXP_TAB[val0 & 63]


def gaussian_kernel_bitexact(n: int, sigma: float):
    """``getGaussianKernelBitExact(n, sigma)`` for ``sigma`` > 0 and odd
    ``n``: → n float64 taps that sum to about 1 (``getGaussianKernel``'s,
    which float32 images are blurred with rounded to float32)."""
    if n < 1 or n % 2 == 0 or sigma <= 0:
        raise ValueError(f"an odd size and sigma > 0, got {n}, {sigma}")
    scale2 = -0.125 / (float(sigma) * float(sigma))
    half = (n - 1) // 2
    values, total = [], 0.0
    x = 1 - n
    for _ in range(half):
        t = soft_exp(float(x * x) * scale2)
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
    """``x·k + acc`` rounded once to ``acc``'s dtype: for float32 an FMA
    (the product is exact in float64, the sum is rounded to odd in float64
    and then to float32, which rounds it correctly); for float64 the
    product and the sum each rounded."""
    if acc.dtype != _F32:
        return x * k + acc
    p = x.astype(np.float64) * float(k)
    c = acc.astype(np.float64)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((e != 0) & even, np.nextafter(s, np.where(e > 0, np.inf, -np.inf)), s)
    return s.astype(_F32)


def _split27(a: np.ndarray):
    """Dekker's split of float64 values into two 26-bit halves."""
    c = a * 134217729.0
    hi = c - (c - a)
    return hi, a - hi


def _fma64(x: np.ndarray, k: float, acc: np.ndarray) -> np.ndarray:
    """``fma(x, k, acc)`` in float64 by error-free transformations: the
    exact product and sum, rounded once but for ties in the last step."""
    p = x * k
    xh, xl = _split27(x)
    kh, kl = _split27(np.float64(k))
    pe = ((xh * kh - p) + xh * kl + xl * kh) + xl * kl
    s = p + acc
    bb = s - p
    se = (p - (s - bb)) + (acc - bb)
    return s + (se + pe)


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
    """The values of each row that OpenCV's row filter leaves to scalar code
    after its vector loops (those compute the vector sum): for float32 at 3
    or 5 taps (``SymmRowSmallFilter``, whose pair loop gives the vector sum)
    only the last value of an odd row, ``fma(S−1 + S1, k1, k0·S0)`` at 3
    taps and ``k0·S0 + k1·(S−1 + S1) + k2·(S−2 + S2)`` without FMAs at 5;
    else the last ``(W·C) % 4`` values, the taps' products added one after
    another (for float32 at 7, 11, 15, ... taps the last two fused)."""
    h, w = rows.shape[:2]
    flat = rows.reshape(h, -1)
    n = len(taps)
    small = n <= 5 and rows.dtype == _F32  # float64 rows take RowFilter at every width
    tail = flat.shape[1] % 2 if small else flat.shape[1] % 4
    if not tail:
        return rows
    r = n // 2
    cn = flat.shape[1] // w
    pf = p.reshape(h, -1)
    start = flat.shape[1] - tail

    def S(k):  # the padded row's values k pixels from each tail value
        return pf[:, start + (r + k) * cn:start + (r + k) * cn + tail]

    if small:
        acc = taps[r] * S(0)
        if n == 3:  # compiled as one FMA
            acc = _madd(S(-1) + S(1), taps[2], acc)
        elif n == 5:
            for k in (1, 2):
                acc = acc + taps[r + k] * (S(-k) + S(k))
    else:
        # float32 with (n − 1) % 4 == 2: the compiled loop's remainder
        # fuses the last two taps
        fused = n - 2 if rows.dtype == _F32 and (n - 1) % 4 == 2 else n
        acc = taps[0] * S(-r)
        for j in range(1, n):
            acc = _madd(S(j - r), taps[j], acc) if j >= fused else acc + taps[j] * S(j - r)
    out = flat.copy()
    out[:, start:] = acc
    return out.reshape(rows.shape)


def _column_tail(out: np.ndarray, q: np.ndarray, taps) -> np.ndarray:
    """The last ``(W·C) % 8`` values of each float32 output row, which the
    column filter computes after its vector loop without FMAs:
    ``k0·S0``, then ``+ k·(S−k + Sk)`` for each pair (at 3 taps,
    ``SymmColumnSmallFilter``, the vector loop's FMA)."""
    h = out.shape[0]
    flat = out.reshape(h, -1)
    tail = flat.shape[1] % 8
    if not tail or len(taps) == 3:
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
    elif n <= 5 and x.dtype == _F32:
        # 3 or 5 taps: SymmRowSmallVec_32f, the inner pair (summed first)
        # times its tap, then an FMA of the centre, then of the outer pair
        pair = lambda k: p[:, r + k:r + k + w] + p[:, r - k:r - k + w]  # noqa: E731
        rows = _madd(pair(1), taps[r + 1], np.zeros(x.shape, x.dtype))
        rows = _madd(p[:, r:r + w], taps[r], rows)
        if n == 5:
            rows = _madd(pair(2), taps[r + 2], rows)
    elif x.dtype == _F32:
        # wider rows: RowVec_32f's FMA chain from zero, tap by tap
        rows = np.zeros(x.shape, x.dtype)
        for j in range(n):
            rows = _madd(p[:, j:j + w], taps[j], rows)
    else:
        # float64 rows at any width: the vector loop's FMA chain from zero
        rows = np.zeros(x.shape, x.dtype)
        for j in range(n):
            rows = _fma64(p[:, j:j + w], float(taps[j]), rows)
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
    → ``cv2.filter2D(x, -1, k)`` (see the module docstring): from
    ``DFT_MIN_TAPS`` taps :func:`dft_filter2d`, below them the nonzero taps
    in row-major order, each one FMA onto a float32 sum from zero, as
    ``FilterVec_32f`` adds them. A float64 array is filtered in float64."""
    x = np.asarray(x)
    k = np.asarray(k)
    if x.dtype not in (np.float32, np.float64) or x.size == 0:
        raise ValueError(f"a non-empty float32 or float64 array, got {x.dtype} {x.shape}")
    if k.ndim != 2 or k.shape[0] != k.shape[1] or k.shape[0] % 2 == 0 or not 3 <= k.shape[0] <= 13:
        raise ValueError(f"an odd square kernel of side 3..13, got {k.shape}")
    n = k.shape[0]
    if n * n >= DFT_MIN_TAPS[x.dtype]:
        return dft_filter2d(x, k)
    r = n // 2
    h, w = x.shape[:2]
    p = _pad101(_pad101(x, r, 0), r, 1)
    acc = np.zeros(x.shape, x.dtype)
    nz = [(i, j) for i in range(n) for j in range(n) if k[i, j] != 0]
    for i, j in nz:
        acc = _madd(p[i:i + h, j:j + w], k[i, j], acc)
    flat = acc.reshape(h, -1)
    tail = flat.shape[1] % 8
    if x.dtype == _F32 and tail:
        # the last (W·C) % 8 values of each row: scalar code without FMAs
        pf = p.reshape(p.shape[0], -1)
        cn = flat.shape[1] // w
        t = np.zeros((h, tail), _F32)
        for i, j in nz:
            src = pf[i:i + h, j * cn + flat.shape[1] - tail:j * cn + flat.shape[1]]
            t = t + k[i, j] * src
        flat[:, -tail:] = t
    return acc


def _cubic_coeffs_f32(t: np.ndarray):
    """OpenCV's ``interpolateCubic`` (A = −0.75) in float32."""
    A, one = _F32(-0.75), _F32(1)
    t = t.astype(_F32)
    c0 = ((A * (t + one) - _F32(5) * A) * (t + one) + _F32(8) * A) * (t + one) - _F32(4) * A
    c1 = ((A + _F32(2)) * t - (A + _F32(3))) * t * t + one
    c2 = ((A + _F32(2)) * (one - t) - (A + _F32(3))) * (one - t) * (one - t) + one
    c3 = one - c0 - c1 - c2
    return [c.astype(_F32) for c in (c0, c1, c2, c3)]


def resize_cubic_f32(x: np.ndarray, width: int, height: int) -> np.ndarray:
    """float32 (h, w) → (height, width), ``cv2.resize(x, (width, height),
    interpolation=cv2.INTER_CUBIC)`` bit for bit as OpenCV's own code
    computes it (``cv2.ipp.setUseIPP(False)``): float32 coordinates and
    weights, each row's four taps summed left to right with replicated edge
    indices, the vertical taps as ``S0·b0 + (S1·b1 + (S2·b2 + S3·b3))`` in
    its 4-lane loop and left to right in the last ``width % 4`` columns."""
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
    out = (r[0] + (r[1] + (r[2] + r[3]))).astype(_F32)
    tail = int(width) % 4
    if tail:
        out[:, -tail:] = ((r[0][:, -tail:] + r[1][:, -tail:]) + r[2][:, -tail:]) + r[3][:, -tail:]
    return out
