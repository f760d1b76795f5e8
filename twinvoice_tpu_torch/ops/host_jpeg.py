"""The JPEG round trip in numpy, as OpenCV's bundled libjpeg-turbo makes it.

The perturbation engine (``data/augment.py``) compresses a photo and reads
it back: ``cv2.imdecode(cv2.imencode(".jpg", bgr, [IMWRITE_JPEG_QUALITY,
q]))``. Entropy coding is lossless, so :func:`jpeg_roundtrip_u8` writes no
bitstream: it runs libjpeg-turbo's lossy stages in its integer arithmetic.

Encoder (``jcparam.c``, ``jccolor.c``, ``jcsample.c``, ``jcprepct.c``,
``jfdctint.c``, ``jcdctmgr.c``):

- the Annex K tables scaled by ``jpeg_quality_scaling`` (q < 50: 5000 / q,
  else 200 − 2q), each entry ``(t·s + 50) // 100`` clamped to 1..255
  (``force_baseline``);
- RGB → YCbCr by the 16-bit fixed-point tables of ``jccolor.c``;
- 4:2:0 (OpenCV's default sampling): luma at full size, chroma by
  ``h2v2_downsample`` (the 2×2 sum plus a bias alternating 1, 2 along each
  row, ``>> 2``);
- edges: each row is extended to its component's whole blocks by repeating
  its last pixel (before downsampling for chroma), an odd last row is
  repeated to make the last 2-row group, and each component's rows are
  extended to its whole blocks by repeating its last (downsampled) row;
- ``jfdctint`` (the islow forward DCT, 13-bit constants, two passes);
- quantisation by libjpeg-turbo's reciprocal multiply (``compute_reciprocal``
  for the divisor ``8·q``: the magnitude plus a correction, times the
  reciprocal, shifted right).

Decoder (``jidctint.c``, ``jdsample.c``, ``jdmainct.c``, ``jdcolor.c``):

- the dequantised ``jidctint`` (islow inverse DCT), +128 and clamped;
- ``h2v2_fancy_upsample`` (triangle filter: 9/16, 3/16, 3/16, 1/16 with
  biases 8 and 7), its row context the first row above the image and the
  last real chroma row below it, repeated; chroma no wider than two samples
  is upsampled by ``h2v2_upsample`` (each sample repeated 2×2);
- YCbCr → RGB by the tables of ``jdcolor.c``.

``tests/test_torch_jpeg.py`` holds it against ``cv2`` byte for byte at every
quality from 1 to 95 on frames whose sides are not multiples of 16.
"""

from __future__ import annotations

import numpy as np

_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int64).reshape(8, 8)
_CHROMA_Q = np.full((8, 8), 99, np.int64)
_CHROMA_Q[:4, :4] = np.array([
    17, 18, 24, 47,
    18, 21, 26, 66,
    24, 26, 56, 99,
    47, 66, 99, 99], np.int64).reshape(4, 4)

_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)
_CONST_BITS = 13
_PASS1_BITS = 2


def _fix(x: float, bits: int) -> int:
    return int(x * (1 << bits) + 0.5)


# jfdctint/jidctint constants (CONST_BITS = 13)
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def quant_tables(quality: int):
    """``jpeg_set_quality(cinfo, quality, force_baseline=TRUE)``'s luma and
    chroma tables, (8, 8) int64 each in natural order."""
    q = int(quality)
    if not 1 <= q <= 100:
        raise ValueError(f"JPEG quality in 1..100, got {quality}")
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (_LUMA_Q, _CHROMA_Q))


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _rgb_to_ycc(rgb: np.ndarray):
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    f = lambda v: _fix(v, _SCALEBITS)  # noqa: E731
    y = (f(0.29900) * r + f(0.58700) * g + f(0.11400) * b + _ONE_HALF) >> _SCALEBITS
    cbcr_off = (128 << _SCALEBITS) + _ONE_HALF - 1
    cb = (-f(0.16874) * r - f(0.33126) * g + f(0.50000) * b + cbcr_off) >> _SCALEBITS
    cr = (f(0.50000) * r - f(0.41869) * g - f(0.08131) * b + cbcr_off) >> _SCALEBITS
    return y, cb, cr


def _pad_rows(x: np.ndarray, rows: int) -> np.ndarray:
    return np.concatenate([x, np.repeat(x[-1:], rows - x.shape[0], 0)], 0) if rows > x.shape[0] else x


def _pad_cols(x: np.ndarray, cols: int) -> np.ndarray:
    return np.concatenate([x, np.repeat(x[:, -1:], cols - x.shape[1], 1)], 1) if cols > x.shape[1] else x


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(8·by, 8·bx) → (by, bx, 8, 8)."""
    by, bx = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3)


def _unblocks(blocks: np.ndarray) -> np.ndarray:
    by, bx = blocks.shape[:2]
    return blocks.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)


def _fdct_pass(d: np.ndarray, first: bool) -> np.ndarray:
    """One ``jfdctint`` pass along the last axis of (..., 8) int64."""
    t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    t10, t13 = t0 + t3, t0 - t3
    t11, t12 = t1 + t2, t1 - t2
    out = np.empty_like(d)
    if first:
        out[..., 0] = (t10 + t11) << _PASS1_BITS
        out[..., 4] = (t10 - t11) << _PASS1_BITS
        n = _CONST_BITS - _PASS1_BITS
    else:
        out[..., 0] = _descale(t10 + t11, _PASS1_BITS)
        out[..., 4] = _descale(t10 - t11, _PASS1_BITS)
        n = _CONST_BITS + _PASS1_BITS
    z1 = (t12 + t13) * _F0541
    out[..., 2] = _descale(z1 + t13 * _F0765, n)
    out[..., 6] = _descale(z1 - t12 * _F1847, n)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * _F1175
    t4, t5, t6, t7 = t4 * _F0298, t5 * _F2053, t6 * _F3072, t7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    out[..., 7] = _descale(t4 + z1 + z3, n)
    out[..., 5] = _descale(t5 + z2 + z4, n)
    out[..., 3] = _descale(t6 + z2 + z3, n)
    out[..., 1] = _descale(t7 + z1 + z4, n)
    return out


def _fdct(blocks: np.ndarray) -> np.ndarray:
    """``jpeg_fdct_islow`` of (..., 8, 8) centred samples: rows, then
    columns; the result is 8× the orthonormal DCT."""
    rows = _fdct_pass(blocks, first=True)
    return np.swapaxes(_fdct_pass(np.swapaxes(rows, -1, -2), first=False), -1, -2)


def _quantize(coef: np.ndarray, qtbl: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's ``quantize`` with ``compute_reciprocal``'s divisors
    for ``8·q`` (16-bit ``DCTELEM``): ±((|c| + corr)·recip >> r)."""
    divisor = qtbl.astype(np.int64) << 3
    b = np.floor(np.log2(divisor)).astype(np.int64)  # flss(divisor) − 1
    r = 16 + b
    one = np.left_shift(np.int64(1), r)
    fq, fr = one // divisor, one % divisor
    c = divisor // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, np.where(fr > divisor // 2, fq + 1, fq))
    r = np.where(pow2, r - 1, r)
    c = np.where(~pow2 & (fr <= divisor // 2), c + 1, c)
    mag = ((np.abs(coef) + c) * fq) >> r
    return np.where(coef < 0, -mag, mag)


def _idct_pass(d: np.ndarray, first: bool) -> np.ndarray:
    """One ``jidctint`` pass along the last axis of (..., 8) int64."""
    z2, z3 = d[..., 2], d[..., 6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 - z3 * _F1847
    tmp3 = z1 + z2 * _F0765
    tmp0 = (d[..., 0] + d[..., 4]) << _CONST_BITS
    tmp1 = (d[..., 0] - d[..., 4]) << _CONST_BITS
    t10, t13 = tmp0 + tmp3, tmp0 - tmp3
    t11, t12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = d[..., 7], d[..., 5], d[..., 3], d[..., 1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * _F1175
    tmp0, tmp1 = tmp0 * _F0298, tmp1 * _F2053
    tmp2, tmp3 = tmp2 * _F3072, tmp3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    tmp0 += z1 + z3
    tmp1 += z2 + z4
    tmp2 += z2 + z3
    tmp3 += z1 + z4
    n = _CONST_BITS - _PASS1_BITS if first else _CONST_BITS + _PASS1_BITS + 3
    out = np.empty_like(d)
    out[..., 0] = _descale(t10 + tmp3, n)
    out[..., 7] = _descale(t10 - tmp3, n)
    out[..., 1] = _descale(t11 + tmp2, n)
    out[..., 6] = _descale(t11 - tmp2, n)
    out[..., 2] = _descale(t12 + tmp1, n)
    out[..., 5] = _descale(t12 - tmp1, n)
    out[..., 3] = _descale(t13 + tmp0, n)
    out[..., 4] = _descale(t13 - tmp0, n)
    return out


def _idct(coef: np.ndarray) -> np.ndarray:
    """``jpeg_idct_islow`` of dequantised (..., 8, 8) coefficients: columns,
    then rows; → samples +128, clamped to 0..255 (int64)."""
    cols = np.swapaxes(_idct_pass(np.swapaxes(coef, -1, -2), first=True), -1, -2)
    return np.clip(_idct_pass(cols, first=False) + 128, 0, 255)


def _lossy(plane: np.ndarray, qtbl: np.ndarray) -> np.ndarray:
    """A component padded to whole blocks → its decoded samples."""
    blocks = _blocks(plane) - 128
    q = _quantize(_fdct(blocks), qtbl)
    return _unblocks(_idct(q * qtbl))


def _downsample_h2v2(x: np.ndarray) -> np.ndarray:
    """``h2v2_downsample`` of an even-sized plane."""
    s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
    bias = np.where(np.arange(s.shape[1]) % 2 == 0, 1, 2)
    return (s + bias) >> 2


def _upsample_h2v2(c: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """Decoded chroma (padded to whole blocks) → (2·dh, 2·dw): libjpeg-turbo's
    ``h2v2_fancy_upsample`` where ``dw`` > 2, else ``h2v2_upsample``."""
    if dw <= 2:
        return np.repeat(np.repeat(c[:dh, :dw], 2, 0), 2, 1)
    rows = c[:dh, :dw]
    above = np.concatenate([rows[:1], rows[:-1]], 0)
    below = np.concatenate([rows[1:], rows[-1:]], 0)
    out = np.empty((2 * dh, 2 * dw), np.int64)
    for v, near in ((0, above), (1, below)):
        col = rows * 3 + near                       # (dh, dw) column sums
        left = np.concatenate([col[:, :1], col[:, :-1]], 1)
        right = np.concatenate([col[:, 1:], col[:, -1:]], 1)
        even = (col * 3 + left + 8) >> 4
        odd = (col * 3 + right + 7) >> 4
        even[:, 0] = (col[:, 0] * 4 + 8) >> 4
        odd[:, -1] = (col[:, -1] * 4 + 7) >> 4
        out[v::2, 0::2] = even
        out[v::2, 1::2] = odd
    return out


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    x_cb, x_cr = cb - 128, cr - 128
    one_half = _ONE_HALF
    cr_r = (_fix(1.40200, _SCALEBITS) * x_cr + one_half) >> _SCALEBITS
    cb_b = (_fix(1.77200, _SCALEBITS) * x_cb + one_half) >> _SCALEBITS
    g = (-_fix(0.34414, _SCALEBITS) * x_cb + one_half - _fix(0.71414, _SCALEBITS) * x_cr) >> _SCALEBITS
    return np.clip(np.stack([y + cr_r, y + g, y + cb_b], -1), 0, 255).astype(np.uint8)


def jpeg_roundtrip_u8(rgb: np.ndarray, quality: int) -> np.ndarray:
    """uint8 (H, W, 3) RGB → the RGB that ``cv2.imdecode(cv2.imencode(".jpg",
    rgb[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality]), cv2.IMREAD_COLOR)
    [..., ::-1]`` returns (baseline 4:2:0 islow JPEG), byte for byte."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.size == 0:
        raise ValueError(f"a non-empty uint8 (H, W, 3) image, got {rgb.dtype} {rgb.shape}")
    qy, qc = quant_tables(quality)
    h, w = rgb.shape[:2]
    y, cb, cr = _rgb_to_ycc(rgb)
    # luma: whole 8×8 blocks, edges repeated
    ly = _pad_cols(_pad_rows(y, -(-h // 8) * 8), -(-w // 8) * 8)
    y_dec = _lossy(ly, qy)[:h, :w]
    # chroma: full-size rows extended to 16·blocks, an odd last row repeated,
    # then downsampled and its rows extended to whole blocks
    dw, dh = -(-w // 2), -(-h // 2)
    cw, ch = -(-dw // 8) * 8, -(-dh // 8) * 8
    planes = []
    for c in (cb, cr):
        full = _pad_cols(_pad_rows(c, 2 * dh), 2 * cw)
        planes.append(_upsample_h2v2(_lossy(_pad_rows(_downsample_h2v2(full), ch), qc),
                                     dw, dh)[:h, :w])
    return _ycc_to_rgb(y_dec, *planes)
