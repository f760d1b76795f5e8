"""JPEG as OpenCV's bundled libjpeg-turbo makes and reads it, without OpenCV.

- :func:`jpeg_roundtrip_u8`: the perturbation engine (``data/augment.py``)
  compresses a photo and reads it back, ``cv2.imdecode(cv2.imencode(".jpg",
  bgr, [IMWRITE_JPEG_QUALITY, q]))``. Entropy coding is lossless, so it
  writes no bitstream: it runs libjpeg-turbo's lossy stages in its integer
  arithmetic.
- :func:`encode_jpeg` writes the file ``cv2.imencode(".jpg", ...)`` writes
  from the same stages: JFIF 1.01, the two tables in zigzag order, SOF0 at
  4:2:0, the four Annex K Huffman tables, one interleaved scan padded with
  ones, EOI.
- :func:`decode_jpeg` reads baseline, extended and progressive Huffman
  files as ``cv2.imdecode(..., IMREAD_COLOR)`` (OpenCV 5.0 on libjpeg-turbo
  3.1): markers, 8- and 16-bit quantisation tables, restart intervals, one
  scan or several, gray, YCbCr, RGB-coded, CMYK and YCCK colour at 4:4:4,
  4:2:2, 4:2:0, 4:4:0 and 4:1:1, a progressive file whose last scans are
  missing (block smoothing), EXIF orientation. It raises on the rest:
  lossless, arithmetic and hierarchical coding, 12-bit samples, a
  progression libjpeg refuses, truncated or corrupt data.

The entropy-coded bits and block smoothing are the host C++ library's
(``csrc/host_codec.cpp``, through ``ops.host_imageio.codec``); everything
else is numpy.

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
  is upsampled by ``h2v2_upsample`` (each sample repeated 2×2); 4:2:2 by
  ``h2v1_fancy_upsample``, 4:4:0 by ``h1v2_fancy_upsample``, 4:1:1 by
  ``int_upsample`` (replication), as ``jdsample.c`` picks them;
- YCbCr → RGB by the tables of ``jdcolor.c``; gray as three equal channels;
  RGB-coded samples as they are; YCCK by ``ycck_cmyk_convert``, then CMYK
  by OpenCV's own step (``_cmyk_to_rgb``); the colour space guessed as
  ``default_decompress_parms`` guesses it (``_colour_space``);
- progressive files (``jdphuff.c``): the scans' coefficients added up, the
  progression checked and ``coef_bits`` kept as ``start_pass_phuff_decoder``
  does; after EOI, where ``jdcoefct.c``'s ``smoothing_ok`` holds, the
  coefficients go through ``decompress_smooth_data``'s block smoothing
  (libjpeg-turbo 2.1 and later: estimates of the first nine AC coefficients
  from a 5×5 window of DC values) before the IDCT. A whole file is not
  smoothed, so it decodes to the pixels of the baseline file with the same
  coefficients.

``tests/test_torch_jpeg.py`` holds the round trip against ``cv2`` byte for
byte at every quality from 1 to 95 on frames whose sides are not multiples
of 16; ``tests/test_torch_imageio.py`` the encoder and the decoder, the
progressive, CMYK, YCCK and RGB-coded forms against cv2 and Pillow's files.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from twinvoice_tpu_torch.ops.host_imageio import (JPEG_SOI, MAX_PIXELS, apply_orientation,
                                                  codec, exif_orientation)

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


_CHUNK_BLOCKS = 1 << 14  # blocks a DCT pass holds at once: bounded memory at phone size


def _forward_plane(plane: np.ndarray, qtbl: np.ndarray) -> np.ndarray:
    """A component padded to whole blocks → its quantised coefficients,
    (by, bx, 64) int16 in natural order."""
    blocks = _blocks(plane)
    by, bx = blocks.shape[:2]
    out = np.empty((by, bx, 64), np.int16)
    step = max(1, _CHUNK_BLOCKS // bx)
    for r in range(0, by, step):
        q = _quantize(_fdct(blocks[r:r + step].astype(np.int64) - 128), qtbl)
        out[r:r + step] = q.reshape(-1, bx, 64)
    return out


def _inverse_plane(coef: np.ndarray, qtbl: np.ndarray) -> np.ndarray:
    """(by, bx, 64) quantised coefficients in natural order → the decoded
    samples, (8·by, 8·bx) uint8."""
    by, bx = coef.shape[:2]
    out = np.empty((by, 8, bx, 8), np.uint8)
    step = max(1, _CHUNK_BLOCKS // bx)
    for r in range(0, by, step):
        blk = coef[r:r + step].reshape(-1, bx, 8, 8).astype(np.int64) * qtbl
        out[r:r + step] = _idct(blk).transpose(0, 2, 1, 3)
    return out.reshape(by * 8, bx * 8)


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


def _upsample_h2v1(c: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """(dh, 2·dw): ``h2v1_fancy_upsample`` (3/4 and 1/4 of the two nearest
    samples, biases 1 and 2; the first and last outputs copied) where ``dw``
    > 2, else ``h2v1_upsample`` (each sample repeated)."""
    rows = c[:dh, :dw]
    if dw <= 2:
        return np.repeat(rows, 2, 1)
    left = np.concatenate([rows[:, :1], rows[:, :-1]], 1)
    right = np.concatenate([rows[:, 1:], rows[:, -1:]], 1)
    out = np.empty((dh, 2 * dw), np.int64)
    out[:, 0::2] = (rows * 3 + left + 1) >> 2
    out[:, 1::2] = (rows * 3 + right + 2) >> 2
    out[:, 0], out[:, -1] = rows[:, 0], rows[:, -1]
    return out


def _upsample_h1v2(c: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """(2·dh, dw): ``h1v2_fancy_upsample`` (3/4 of the nearest row and 1/4 of
    the next, bias 1 above and 2 below; the row context as h2v2's)."""
    rows = c[:dh, :dw]
    above = np.concatenate([rows[:1], rows[:-1]], 0)
    below = np.concatenate([rows[1:], rows[-1:]], 0)
    out = np.empty((2 * dh, dw), np.int64)
    out[0::2] = (rows * 3 + above + 1) >> 2
    out[1::2] = (rows * 3 + below + 2) >> 2
    return out


def _upsample(c: np.ndarray, factor, h: int, w: int) -> np.ndarray:
    """A decoded component whose samples are ``factor`` = (fh, fv) image
    pixels wide and tall → (h, w), as libjpeg-turbo's ``jdsample.c`` picks
    its method (fancy upsampling on, ``cv2.imread``'s default)."""
    fh, fv = factor
    dw, dh = -(-w // fh), -(-h // fv)
    c = c.astype(np.int64)
    if factor == (1, 1):
        out = c
    elif factor == (2, 2):
        out = _upsample_h2v2(c, dw, dh)
    elif factor == (2, 1):
        out = _upsample_h2v1(c, dw, dh)
    elif factor == (1, 2):
        out = _upsample_h1v2(c, dw, dh)
    else:  # int_upsample: each sample repeated fh × fv times
        out = np.repeat(np.repeat(c[:dh, :dw], fv, 0), fh, 1)
    return out[:h, :w]


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    x_cb, x_cr = cb - 128, cr - 128
    one_half = _ONE_HALF
    cr_r = (_fix(1.40200, _SCALEBITS) * x_cr + one_half) >> _SCALEBITS
    cb_b = (_fix(1.77200, _SCALEBITS) * x_cb + one_half) >> _SCALEBITS
    g = (-_fix(0.34414, _SCALEBITS) * x_cb + one_half - _fix(0.71414, _SCALEBITS) * x_cr) >> _SCALEBITS
    return np.clip(np.stack([y + cr_r, y + g, y + cb_b], -1), 0, 255).astype(np.uint8)


def _cmyk_to_rgb(c, m, y, k) -> np.ndarray:
    """OpenCV's own CMYK → BGR step after libjpeg (``icvCvt_CMYK2BGR_8u_C4C3R``
    in its ``utils.cpp``), on libjpeg's CMYK samples as stored (Adobe's
    inverted ink): each channel ``k − ((255 − x)·k >> 8)``, R from C, G from M,
    B from Y."""
    return np.stack([k - (((255 - x) * k) >> 8) for x in (c, m, y)], -1).astype(np.uint8)


def _to_rgb(comps, h: int, w: int, colour: str) -> np.ndarray:
    """Decoded components → RGB (H, W, 3) uint8. ``comps``: one, three or
    four of (coefficients (by, bx, 64), quantisation table (8, 8), (fh,
    fv)), each with at least the blocks its samples need. ``colour``:
    libjpeg's colour space: ``"gray"`` (three equal channels), ``"ycc"``
    (``jdcolor.c``'s YCbCr tables), ``"rgb"`` (the samples as they are),
    ``"cmyk"`` or ``"ycck"`` (``ycck_cmyk_convert``: 255 minus the YCbCr
    tables' RGB, K as it is; then OpenCV's CMYK step)."""
    planes = []
    for coef, qtbl, (fh, fv) in comps:
        by, bx = -(-h // (8 * fv)), -(-w // (8 * fh))  # the blocks of ceil(h / fv) rows
        planes.append(_upsample(_inverse_plane(coef[:by, :bx], qtbl), (fh, fv), h, w))
    if colour == "gray":
        return np.repeat(planes[0][..., None].astype(np.uint8), 3, -1)
    if colour == "rgb":
        return np.stack(planes, -1).astype(np.uint8)
    if colour == "ycc":
        return _ycc_to_rgb(*planes)
    if colour == "ycck":
        cmy = 255 - _ycc_to_rgb(*planes[:3]).astype(np.int64)
        planes[:3] = [cmy[..., i] for i in range(3)]
    return _cmyk_to_rgb(*planes)


def _forward(rgb: np.ndarray, quality: int):
    """The encoder's stages (``jpeg_set_quality``, 4:2:0) → (luma table,
    chroma table, [Y, Cb, Cr] quantised coefficients (by, bx, 64) int16 of
    each component's own blocks)."""
    qy, qc = quant_tables(quality)
    h, w = rgb.shape[:2]
    y, cb, cr = _rgb_to_ycc(rgb)
    # luma: whole 8×8 blocks, edges repeated
    coefs = [_forward_plane(_pad_cols(_pad_rows(y, -(-h // 8) * 8), -(-w // 8) * 8), qy)]
    # chroma: full-size rows extended to 16·blocks, an odd last row repeated,
    # then downsampled and its rows extended to whole blocks
    dw, dh = -(-w // 2), -(-h // 2)
    cw, ch = -(-dw // 8) * 8, -(-dh // 8) * 8
    for c in (cb, cr):
        full = _pad_cols(_pad_rows(c, 2 * dh), 2 * cw)
        coefs.append(_forward_plane(_pad_rows(_downsample_h2v2(full), ch), qc))
    return qy, qc, coefs


def _check_rgb(rgb) -> np.ndarray:
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.size == 0:
        raise ValueError(f"a non-empty uint8 (H, W, 3) image, got {rgb.dtype} {rgb.shape}")
    return rgb


def jpeg_roundtrip_u8(rgb: np.ndarray, quality: int) -> np.ndarray:
    """uint8 (H, W, 3) RGB → the RGB that ``cv2.imdecode(cv2.imencode(".jpg",
    rgb[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality]), cv2.IMREAD_COLOR)
    [..., ::-1]`` returns (baseline 4:2:0 islow JPEG), byte for byte."""
    rgb = _check_rgb(rgb)
    qy, qc, (y, cb, cr) = _forward(rgb, quality)
    return _to_rgb([(y, qy, (1, 1)), (cb, qc, (2, 2)), (cr, qc, (2, 2))], *rgb.shape[:2],
                   "ycc")


# -- the file codec ---------------------------------------------------------

# the natural (row-major) index of each zigzag position
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# Annex K.3's tables, as counts of codes of lengths 1-16 and then the symbols
_STD_HUFFMAN = {
    (0, 0): bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, *range(12)]),
    (0, 1): bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, *range(12)]),
    (1, 0): bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]) + bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
        "535455565758595a636465666768696a737475767778797a838485868788898a"
        "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
        "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    (1, 1): bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]) + bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"),
}
_TABLE_BYTES = 16 + 256  # one table as csrc/host_codec.cpp takes it

# chroma (fh, fv): image pixels a sample covers → the sampling's name
SAMPLINGS = {(1, 1): "4:4:4", (2, 1): "4:2:2", (2, 2): "4:2:0", (1, 2): "4:4:0",
             (4, 1): "4:1:1"}
_REFUSED_SOF = {0xC3: "lossless (SOF3)",
                **{m: f"hierarchical (SOF{m - 0xC0})" for m in (0xC5, 0xC6, 0xC7)},
                **{m: f"arithmetic-coded (SOF{m - 0xC0})" for m in (0xC9, 0xCA, 0xCB, 0xCD,
                                                                     0xCE, 0xCF)},
                0xCC: "arithmetic-coded (DAC)", 0xDC: "DNL-sized (DNL)",
                0xDE: "hierarchical (DHP)", 0xDF: "hierarchical (EXP)"}
_SCAN_ERRORS = {-1: "truncated entropy-coded data", -2: "corrupt entropy-coded data (no "
                "Huffman code matches)", -3: "corrupt entropy-coded data (a restart marker "
                "missing or out of order)", -4: "corrupt entropy-coded data (a run past the "
                "64th coefficient)", -5: "a Huffman table that is over-full or lacks a symbol",
                -9: "corrupt entropy-coded data (a DC value out of range)"}
# the natural positions of the first ten coefficients in zigzag order: those
# block smoothing estimates (jdcoefct.c's Q00_POS..Q30_POS)
_SMOOTHED = _NATURAL[:10]


def _table_bytes(counts_and_symbols: bytes) -> bytes:
    return counts_and_symbols.ljust(_TABLE_BYTES, b"\0")


class _Frame:
    """A frame as SOF0, SOF1 or SOF2 gives it, with its coefficient buffers
    and, for SOF2, libjpeg's ``coef_bits``: for each component and
    coefficient the Al of the last scan that coded it, -1 before any did."""

    def __init__(self, seg: bytes, progressive: bool):
        if len(seg) < 6:
            raise ValueError("JPEG: a truncated SOF segment")
        precision, self.h, self.w, n = seg[0], *struct.unpack(">HH", seg[1:5]), seg[5]
        if precision != 8:
            raise ValueError(f"JPEG: {precision}-bit precision is not supported (8-bit only)")
        if n not in (1, 3, 4) or len(seg) != 6 + 3 * n:
            raise ValueError(f"JPEG: {n} components are not supported")
        if self.h == 0 or self.w == 0:
            raise ValueError(f"JPEG: a {self.w}×{self.h} frame (a height set by DNL is not "
                             f"supported)")
        if self.w * self.h > MAX_PIXELS:
            raise ValueError(f"JPEG: a {self.w}×{self.h} frame is more than {MAX_PIXELS} "
                             f"pixels")
        self.ids = list(seg[6::3])
        self.hv = [(b >> 4, b & 15) for b in seg[7::3]]
        self.tq = list(seg[8::3])
        if any(not (1 <= h <= 4 and 1 <= v <= 4) for h, v in self.hv) or any(
                t > 3 for t in self.tq) or len(set(self.ids)) != n:
            raise ValueError(f"JPEG: a corrupt SOF segment {seg.hex()}")
        self.hmax, self.vmax = max(h for h, _ in self.hv), max(v for _, v in self.hv)
        self.factors = [(self.hmax // h, self.vmax // v) for h, v in self.hv]
        if n > 1 and (any(self.hmax % h or self.vmax % v for h, v in self.hv)
                      or (n == 3 and self.factors[0] != (1, 1))
                      or any(f not in SAMPLINGS for f in self.factors[n == 3:])):
            raise ValueError(f"JPEG: sampling factors {self.hv} are not supported (the first "
                             f"of three components at the largest; the others at "
                             f"{', '.join(SAMPLINGS.values())})")
        self.mcus = (-(-self.w // (8 * self.hmax)), -(-self.h // (8 * self.vmax)))
        self.coefs = [np.zeros((self.mcus[1] * v, self.mcus[0] * h, 64), np.int16)
                      for h, v in self.hv]
        self.qtables = [None] * n  # latched at each component's first scan, as libjpeg does
        self.progressive = progressive
        self.coef_bits = np.full((n, 64), -1, np.int32)

    def blocks(self, c: int):
        """Component ``c``'s own blocks (across, down): those of its
        ceil(w·h / hmax) × ceil(h·v / vmax) samples."""
        h, v = self.hv[c]
        return -(-self.w * h // (8 * self.hmax)), -(-self.h * v // (8 * self.vmax))

    def progression(self, comps, ss: int, se: int, ah: int, al: int):
        """jdphuff.c's ``start_pass_phuff_decoder``: a scan whose parameters
        libjpeg refuses (``JERR_BAD_PROGRESSION``; cv2 reads no image)
        raises; one out of order (a refinement of bits never sent, a scan
        repeated) only warns there, so it is decoded here too. Then the
        scan's coefficients are marked known down to bit ``al``."""
        dc = ss == 0
        bad = (se != 0) if dc else (ss > se or se > 63 or len(comps) != 1)
        if (ah != 0 and al != ah - 1) or al > 13 or bad:
            raise ValueError(f"JPEG: a bad progression (Ss {ss}, Se {se}, Ah {ah}, Al {al}): "
                             f"a scan libjpeg refuses")
        for c in comps:
            self.coef_bits[c, ss:se + 1] = al

    def smoothing(self):
        """jdcoefct.c's ``smoothing_ok`` once every scan is in (and every
        component was scanned, so its table is latched): block
        smoothing runs where the frame is progressive, every component's
        quantisation values at the ten smoothed positions are nonzero, every
        DC is at least partly known, and some component's first nine AC
        coefficients are not all known to their last bit."""
        if not self.progressive or any(not q.reshape(64)[_SMOOTHED].all()
                                       for q in self.qtables):
            return False
        return bool((self.coef_bits[:, 0] >= 0).all() and self.coef_bits[:, 1:10].any())

    def smoothed(self, c: int) -> np.ndarray:
        """Component ``c``'s coefficients after ``jpeg_smooth_blocks``."""
        out = self.coefs[c].copy()
        across, down = self.blocks(c)
        params = np.array([out.shape[1], across, down, self.hv[c][1], self.mcus[1]], np.int32)
        bits = np.ascontiguousarray(self.coef_bits[c, :10])
        qt = np.ascontiguousarray(self.qtables[c].reshape(64), np.int32)
        rc = codec().jpeg_smooth_blocks(self.coefs[c].ctypes.data, out.ctypes.data,
                                        params.ctypes.data, bits.ctypes.data, qt.ctypes.data)
        if rc:
            raise RuntimeError(f"JPEG block smoothing error {rc}")
        return out


def _decode_scan(data: bytes, pos: int, seg: bytes, frame: _Frame, qt: dict, ht: dict,
                 restart: int) -> tuple:
    """One SOS: its header ``seg``, its entropy-coded data from ``data[pos]``
    into ``frame``'s buffers. → (the position of the marker after it, the
    components it held)."""
    n = seg[0] if seg else 0
    if not 1 <= n <= 4 or len(seg) != 4 + 2 * n:
        raise ValueError("JPEG: a corrupt SOS segment")
    ss, se, ahal = seg[1 + 2 * n:4 + 2 * n]
    ah, al = ahal >> 4, ahal & 15
    if not frame.progressive and (ss != 0 or se != 63 or ahal != 0):
        raise ValueError(f"JPEG: a scan with Ss {ss}, Se {se}, Ah/Al {ahal:#x} is not a "
                         f"baseline sequential scan")
    comps = []
    for cid, t in zip(seg[1:1 + 2 * n:2], seg[2:2 + 2 * n:2]):
        if cid not in frame.ids:
            raise ValueError(f"JPEG: the scan names component {cid}, which the frame lacks")
        c = frame.ids.index(cid)
        if any(c == d for d, _ in comps):
            raise ValueError(f"JPEG: the scan names component {cid} twice")
        comps.append((c, t))
    if n > 1 and sum(frame.hv[c][0] * frame.hv[c][1] for c, _ in comps) > 10:
        raise ValueError("JPEG: more than 10 blocks in an MCU")
    for c, _ in comps:
        if frame.qtables[c] is None:
            if frame.tq[c] not in qt:
                raise ValueError(f"JPEG: no quantisation table {frame.tq[c]}")
            frame.qtables[c] = qt[frame.tq[c]].copy()
    if frame.progressive:
        frame.progression([c for c, _ in comps], ss, se, ah, al)
    # a progressive DC scan codes with its DC table (a refinement with none),
    # an AC scan with its AC table; a sequential scan with both
    kinds = (1,) if ss else () if ah else (0,) if frame.progressive else (0, 1)
    tables = [bytes(_TABLE_BYTES)] * 8
    for c, t in comps:
        for kind in kinds:
            slot = t >> 4 if kind == 0 else t & 15
            if slot > 3:
                raise ValueError("JPEG: a scan names a Huffman table slot above 3")
            # jdhuff.c fills the Annex K tables into empty slots 0 and 1 (for
            # Motion JPEG); jdphuff.c does not, so a progressive file must define its own
            table = ht.get((kind, slot),
                           None if frame.progressive else _STD_HUFFMAN.get((kind, slot)))
            if table is None:
                raise ValueError(f"JPEG: no Huffman table {(kind, slot)}")
            tables[4 * kind + slot] = _table_bytes(table)
    comps = [(c, t >> 4, 4 + (t & 15)) for c, t in comps]
    if n == 1:  # a single-component scan: one block an MCU, the component's own blocks
        c, dc, ac = comps[0]
        across, down = frame.blocks(c)
        params = [1, across, down, restart]
        comp_params = [1, 1, frame.coefs[c].shape[1], dc, ac]
    else:
        params = [n, *frame.mcus, restart]
        comp_params = []
        for c, dc, ac in comps:
            comp_params += [*frame.hv[c], frame.coefs[c].shape[1], dc, ac]
    if frame.progressive:  # the coefficients add up across scans
        params += [ss, se, ah, al]
        decode = codec().jpeg_decode_progressive_scan
    else:
        for c, _, _ in comps:
            frame.coefs[c][:] = 0
        decode = codec().jpeg_decode_scan
    params = np.array(params + comp_params, np.int32)
    ptrs = (ctypes.c_void_p * n)(*(frame.coefs[c].ctypes.data for c, _, _ in comps))
    table_buf = b"".join(tables)
    end = ctypes.c_int64(0)
    rc = decode(data, len(data), pos, params.ctypes.data, table_buf, ptrs, ctypes.byref(end))
    if rc:
        raise ValueError(f"JPEG: {_SCAN_ERRORS.get(rc, f'scan decoder error {rc}')}")
    return end.value, [c for c, _, _ in comps]


def _parse_tables(m: int, seg: bytes, qt: dict, ht: dict):
    i = 0
    while i < len(seg):
        kind, slot = seg[i] >> 4, seg[i] & 15
        i += 1
        if m == 0xDB:  # DQT: 8- or 16-bit entries, zigzag order
            size = 64 * (1 + kind)
            if kind > 1 or slot > 3 or i + size > len(seg):
                raise ValueError("JPEG: a corrupt DQT segment")
            table = np.zeros(64, np.int64)
            table[_NATURAL] = np.frombuffer(seg[i:i + size], ">u2" if kind else np.uint8)
            qt[slot] = table.reshape(8, 8)
            i += size
        else:  # DHT
            counts = seg[i:i + 16]
            n = sum(counts)
            if kind > 1 or slot > 3 or len(counts) < 16 or n > 256 or i + 16 + n > len(seg):
                raise ValueError("JPEG: a corrupt DHT segment")
            symbols = seg[i + 16:i + 16 + n]
            if kind == 0 and max(symbols, default=0) > 15:
                raise ValueError("JPEG: a DC Huffman table with a category above 15")
            ht[(kind, slot)] = counts + symbols
            i += 16 + n


def _colour_space(frame: _Frame, jfif: bool, adobe) -> str:
    """libjpeg-turbo's ``default_decompress_parms``: one component is gray;
    three are YCbCr where a JFIF APP0 was seen, else RGB for an Adobe APP14
    transform of 0 (YCbCr for any other), else RGB for the component IDs
    ``R``, ``G``, ``B`` (YCbCr for any others); four are CMYK without an
    Adobe APP14 or with transform 0, else YCCK."""
    n = len(frame.ids)
    if n == 1:
        return "gray"
    if n == 4:
        return "cmyk" if adobe in (None, 0) else "ycck"
    if jfif:
        return "ycc"
    if adobe is not None:
        return "rgb" if adobe == 0 else "ycc"
    return "rgb" if frame.ids == [82, 71, 66] else "ycc"


def decode_jpeg(data: bytes) -> np.ndarray:
    """A JPEG file's bytes → the RGB uint8 (H, W, 3) array that
    ``cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1]`` returns (libjpeg-turbo
    3.1 with its defaults: islow IDCT, fancy upsampling, block smoothing),
    EXIF orientation from the first APP1 applied.

    Read: baseline, extended and progressive Huffman coding at 8 bits, one
    scan or several; gray, YCbCr, RGB-coded (an Adobe transform of 0, or the
    component IDs R, G, B without JFIF), CMYK and YCCK (four components,
    OpenCV's own CMYK → RGB step after libjpeg's), at 4:4:4, 4:2:2, 4:2:0,
    4:4:0 and 4:1:1; restart intervals; a progressive file whose last scans
    are missing, through libjpeg-turbo's block smoothing. Grayscale comes
    back as three equal channels.

    Raises ``ValueError`` with the reason on any file it does not decode
    whole: lossless, arithmetic or hierarchical coding, 12-bit samples, a
    progression libjpeg refuses, other samplings or component counts, a
    frame of more than ``MAX_PIXELS``, truncated or corrupt entropy-coded
    data, a component no scan coded."""
    data = bytes(data)
    if data[:2] != JPEG_SOI:
        raise ValueError("not a JPEG file: no SOI marker")
    qt, ht, restart, frame, exif = {}, {}, 0, None, None
    jfif, adobe, scanned, colour = False, None, set(), None
    pos = 2
    while True:
        pos = data.find(b"\xff", pos)  # garbage before a marker is skipped, as libjpeg does
        while 0 <= pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos < 0 or pos >= len(data):
            raise ValueError("JPEG: truncated: no EOI marker")  # cv2 reads no image either
        m = data[pos]
        pos += 1
        if m == 0xD9:  # EOI
            break
        if m == 0 or m == 0x01 or 0xD0 <= m <= 0xD7:
            continue  # a stray stuffed byte, TEM or RSTn: no parameters
        if m == 0xD8:
            raise ValueError("JPEG: a second SOI marker")
        if pos + 2 > len(data):
            raise ValueError(f"JPEG: truncated at marker 0x{m:02X}")
        length = struct.unpack_from(">H", data, pos)[0]
        if length < 2 or pos + length > len(data):
            raise ValueError(f"JPEG: a truncated segment at marker 0x{m:02X}")
        seg, pos = data[pos + 2:pos + length], pos + length
        if 0xE0 <= m <= 0xEF:
            if m == 0xE0 and len(seg) >= 14 and seg[:5] == b"JFIF\0":
                jfif = True
            elif m == 0xE1 and exif is None:
                exif = seg[6:]  # OpenCV reads the first APP1 past its 6-byte "Exif\0\0"
            elif m == 0xEE and len(seg) >= 12 and seg[:5] == b"Adobe":
                adobe = seg[11]
        elif m in (0xDB, 0xC4):
            _parse_tables(m, seg, qt, ht)
        elif m == 0xDD:
            if len(seg) != 2:
                raise ValueError("JPEG: a corrupt DRI segment")
            restart = struct.unpack(">H", seg)[0]
        elif m in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError("JPEG: a second SOF marker")
            frame = _Frame(seg, progressive=m == 0xC2)
        elif m in _REFUSED_SOF:
            raise ValueError(f"JPEG: {_REFUSED_SOF[m]} coding is not supported (baseline, "
                             f"extended and progressive Huffman only)")
        elif m == 0xDA:
            if frame is None:
                raise ValueError("JPEG: SOS before SOF")
            if colour is None:  # libjpeg settles it at the first SOS
                colour = _colour_space(frame, jfif, adobe)
            pos, comps = _decode_scan(data, pos, seg, frame, qt, ht, restart)
            scanned.update(comps)
        elif m != 0xFE:  # COM is skipped
            raise ValueError(f"JPEG: unsupported marker 0x{m:02X}")
    if frame is None:
        raise ValueError("JPEG: no SOF marker")
    if len(scanned) != len(frame.ids):
        raise ValueError("JPEG: truncated before every component was scanned")
    coefs = frame.coefs
    if frame.smoothing():
        coefs = [frame.smoothed(c) for c in range(len(coefs))]
    rgb = _to_rgb(list(zip(coefs, frame.qtables, frame.factors)), frame.h, frame.w, colour)
    return apply_orientation(rgb, exif_orientation(exif)) if exif else rgb


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """uint8 (H, W, 3) RGB → the bytes of ``cv2.imencode(".jpg", rgb[...,
    ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])`` (libjpeg-turbo's defaults:
    JFIF 1.01, 4:2:0, the Annex K Huffman tables, one interleaved scan)."""
    rgb = _check_rgb(rgb)
    h, w = rgb.shape[:2]
    if h > 65500 or w > 65500:
        raise ValueError(f"JPEG: a {w}×{h} image is larger than 65500 a side")
    qy, qc, (y, cb, cr) = _forward(rgb, quality)
    mx, my = -(-w // 16), -(-h // 16)
    # luma on the whole MCUs: a dummy block (AC zero) repeats the DC of the
    # block before it in its MCU, as jccoefct.c's compress_data makes them
    grid = np.zeros((2 * my, 2 * mx, 64), np.int16)
    by, bx = y.shape[:2]
    grid[:by, :bx] = y
    if bx < 2 * mx:
        grid[:by, bx, 0] = y[:, bx - 1, 0]
    if by < 2 * my:
        grid[by, :, 0] = np.repeat(grid[by - 1, 1::2, 0], 2)
    params = np.array([3, mx, my, 0, 2, 2, 2 * mx, 0, 4, 1, 1, mx, 1, 5, 1, 1, mx, 1, 5],
                      np.int32)
    tables = [bytes(_TABLE_BYTES)] * 8
    for (kind, slot), t in _STD_HUFFMAN.items():
        tables[4 * kind + slot] = _table_bytes(t)
    planes = [grid, cb, cr]
    ptrs = (ctypes.c_void_p * 3)(*(p.ctypes.data for p in planes))
    # a block codes to at most 27 + 63·26 bits (209 bytes), twice that stuffed
    cap = 1024 + 420 * sum(p.shape[0] * p.shape[1] for p in planes)
    out = np.empty(cap, np.uint8)
    n = codec().jpeg_encode_scan(params.ctypes.data, b"".join(tables), ptrs, out.ctypes.data,
                                 cap)
    if n < 0:
        raise RuntimeError(f"JPEG encoder error {n}")
    jfif = b"JFIF\0" + bytes([1, 1, 0, 0, 1, 0, 1, 0, 0])
    dqt = [bytes([i]) + bytes(t.reshape(64)[_NATURAL].astype(np.uint8)) for i, t in
           enumerate((qy, qc))]
    sof = struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    dht = [bytes([16 * kind + slot]) + _STD_HUFFMAN[(kind, slot)]
           for kind, slot in ((0, 0), (1, 0), (0, 1), (1, 1))]
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return b"".join([JPEG_SOI, _segment(0xE0, jfif), *(_segment(0xDB, d) for d in dqt),
                     _segment(0xC0, sof), *(_segment(0xC4, d) for d in dht),
                     _segment(0xDA, sos), out[:n].tobytes(), b"\xff\xd9"])
