"""Perspective geometry in numpy, bit-equal to OpenCV 5's.

The perturbation engine (``data/augment.py``) composes rotation, scale,
translation and perspective into one 3×3 matrix and warps the image
(bilinear) and its mask (nearest) with it, so the ground-truth boxes move
with the text. This module computes what OpenCV's calls compute:

- :func:`get_perspective_transform`: ``cv2.getPerspectiveTransform`` (its
  8×8 system solved by OpenCV's own ``DECOMP_LU``: Gaussian elimination with
  partial pivoting, no fused multiply-add), to the float64 bit;
- :func:`invert_3x3`: the closed-form inverse ``cv2.invert`` takes for
  n ≤ 3, which ``warpPerspective`` applies to its matrix;
- :func:`invert_affine`: the inverse ``warpAffine`` applies to its 2×3
  matrix;
- :func:`rotation_matrix_2d`: ``cv2.getRotationMatrix2D``;
- :func:`warp_perspective_u8`: ``cv2.warpPerspective`` on uint8 at
  ``INTER_LINEAR`` (``BORDER_REPLICATE`` or ``BORDER_CONSTANT``) and
  ``INTER_NEAREST`` (``BORDER_CONSTANT``), byte for byte;
- :func:`warp_affine_f32`: ``cv2.warpAffine`` on float32 at
  ``INTER_LINEAR``, ``BORDER_CONSTANT`` 0;
- :func:`warp_affine_u8`: ``cv2.warpAffine`` on uint8 at ``INTER_LINEAR``,
  ``BORDER_CONSTANT`` (the line renderer's shear);
- :func:`remap_linear_f32`: ``cv2.remap`` on float32 with float maps at
  ``INTER_LINEAR``, ``BORDER_REPLICATE`` (its elastic warp).

The warps follow the optimized (AVX2) kernels of OpenCV 5's
``warp_kernels.simd.hpp``, not its scalar build, whose bytes differ:

- the inverse matrix is rounded to float32;
- each row is walked 16 pixels at a time while 16 remain: the source
  coordinate is ``fma(M0, x, y·M1 + M2)`` (and the same for the other two
  rows of the matrix), then divided by the third;
- the remaining pixels of the row compute ``fma(x, M0, y·M1) + M2``;
- bilinear: ``ix = floor(sx)``, ``a = sx − ix``, the two horizontal lerps
  and the vertical one each one float32 FMA (``p0 + a·(p1 − p0)``), then
  rounded half to even; nearest: ``rint(sx)``;
- a neighbour off the image is the border value (constant) or the nearest
  edge pixel (replicate).

numpy has no float32 FMA: :func:`fma32` rounds the exact float64 product and
sum once to float32. ``tests/test_torch_warp.py`` holds each function
against ``cv2`` on seeded sweeps.
"""

from __future__ import annotations

import math

import numpy as np

_F32 = np.float32
_VECTOR = 16  # pixels a row takes per step of the AVX2 kernel

INTER_NEAREST, INTER_LINEAR = "nearest", "linear"
BORDER_CONSTANT, BORDER_REPLICATE = "constant", "replicate"


def fma32(a, b, c) -> np.ndarray:
    """float32 ``a·b + c`` rounded once (``fmaf``), elementwise.

    The product of two float32 values is exact in float64, so the float64
    sum rounded to float32 is the correct result unless that sum lands
    exactly halfway between two float32 values (its low 29 mantissa bits
    are 1 followed by zeros) while the exact sum does not: there the sum's
    error, exact by TwoSum, decides the side. Results below float32's
    normal range take the same careful path."""
    a = np.asarray(a, _F32).astype(np.float64)
    b = np.asarray(b, _F32).astype(np.float64)
    c = np.asarray(c, _F32).astype(np.float64)
    p = a * b
    s = p + c
    r = s.astype(_F32)
    low = s.view(np.int64) & ((1 << 29) - 1)
    careful = (low == (1 << 28)) | (np.abs(s) < 2.0 ** -125)
    if careful.any():
        p, c, sc = (np.broadcast_to(v, s.shape)[careful] for v in (p, c, s))
        bv = sc - p
        err = (p - (sc - bv)) + (c - bv)
        rc = sc.astype(_F32)
        d = sc - rc.astype(np.float64)
        other = np.nextafter(rc, np.where(d > 0, _F32(np.inf), _F32(-np.inf)).astype(_F32))
        midpoint = (d != 0) & (sc == (rc.astype(np.float64) + other.astype(np.float64)) / 2)
        away = midpoint & (err != 0) & ((err > 0) == (d > 0))
        r = np.array(r, copy=True)
        r[careful] = np.where(away, other, rc)
    return r


def get_perspective_transform(src, dst) -> np.ndarray:
    """4 float32 source points, 4 float32 destination points → the float64
    3×3 matrix ``cv2.getPerspectiveTransform(src, dst)`` returns, bit for
    bit: the 8×8 system (its products of two float32 coordinates taken in
    float32) solved by OpenCV's LU elimination."""
    src = np.asarray(src, _F32).reshape(4, 2)
    dst = np.asarray(dst, _F32).reshape(4, 2)
    a = [[0.0] * 8 for _ in range(8)]
    b = [0.0] * 8
    for i in range(4):
        sx, sy = src[i]
        dx, dy = dst[i]
        a[i][0] = a[i + 4][3] = float(sx)
        a[i][1] = a[i + 4][4] = float(sy)
        a[i][2] = a[i + 4][5] = 1.0
        a[i][6] = float(-sx * dx)
        a[i][7] = float(-sy * dx)
        a[i + 4][6] = float(-sx * dy)
        a[i + 4][7] = float(-sy * dy)
        b[i], b[i + 4] = float(dx), float(dy)
    n = 8
    eps = float(np.finfo(np.float64).eps) * 100  # hal::LU64f's DBL_EPSILON*100
    for i in range(n):
        k = i
        for j in range(i + 1, n):
            if abs(a[j][i]) > abs(a[k][i]):
                k = j
        if abs(a[k][i]) < eps:
            raise ValueError("getPerspectiveTransform: the points are degenerate")
        if k != i:
            a[i], a[k] = a[k], a[i]
            b[i], b[k] = b[k], b[i]
        d = -1.0 / a[i][i]
        for j in range(i + 1, n):
            alpha = a[j][i] * d
            for kk in range(i + 1, n):
                a[j][kk] += alpha * a[i][kk]
            b[j] += alpha * b[i]
    for i in range(n - 1, -1, -1):
        s = b[i]
        for kk in range(i + 1, n):
            s -= a[i][kk] * b[kk]
        b[i] = s / a[i][i]
    return np.array(b + [1.0], np.float64).reshape(3, 3)


def invert_3x3(m) -> np.ndarray:
    """float64 3×3 → its inverse as ``cv2.invert(m)`` (``DECOMP_LU``) computes
    it: the determinant by cofactors, ``1/det`` times each cofactor."""
    m = np.asarray(m, np.float64).reshape(3, 3)
    S = [[float(v) for v in row] for row in m]
    det = (S[0][0] * (S[1][1] * S[2][2] - S[1][2] * S[2][1])
           - S[0][1] * (S[1][0] * S[2][2] - S[1][2] * S[2][0])
           + S[0][2] * (S[1][0] * S[2][1] - S[1][1] * S[2][0]))
    if det == 0.0:
        raise ValueError("invert_3x3: the matrix is singular")
    d = 1.0 / det
    t = [(S[1][1] * S[2][2] - S[1][2] * S[2][1]) * d,
         (S[0][2] * S[2][1] - S[0][1] * S[2][2]) * d,
         (S[0][1] * S[1][2] - S[0][2] * S[1][1]) * d,
         (S[1][2] * S[2][0] - S[1][0] * S[2][2]) * d,
         (S[0][0] * S[2][2] - S[0][2] * S[2][0]) * d,
         (S[0][2] * S[1][0] - S[0][0] * S[1][2]) * d,
         (S[1][0] * S[2][1] - S[1][1] * S[2][0]) * d,
         (S[0][1] * S[2][0] - S[0][0] * S[2][1]) * d,
         (S[0][0] * S[1][1] - S[0][1] * S[1][0]) * d]
    return np.array(t, np.float64).reshape(3, 3)


def invert_affine(m) -> np.ndarray:
    """float64 2×3 → its inverse as ``warpAffine`` computes it when
    ``WARP_INVERSE_MAP`` is unset (``cv2.invertAffineTransform``'s
    formulas)."""
    M = [float(v) for v in np.asarray(m, np.float64).reshape(6)]
    det = M[0] * M[4] - M[1] * M[3]
    if det == 0.0:
        raise ValueError("invert_affine: the matrix is singular")
    d = 1.0 / det
    a11, a22 = M[4] * d, M[0] * d
    M[0], M[1], M[3], M[4] = a11, M[1] * -d, M[3] * -d, a22
    b1 = -M[0] * M[2] - M[1] * M[5]
    b2 = -M[3] * M[2] - M[4] * M[5]
    M[2], M[5] = b1, b2
    return np.array(M, np.float64).reshape(2, 3)


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: the float64 2×3
    matrix of a rotation by ``angle`` degrees (counter-clockwise) about the
    float32 ``center``, scaled."""
    a = float(angle) * (math.pi / 180)
    alpha = math.cos(a) * float(scale)
    beta = math.sin(a) * float(scale)
    cx, cy = (float(_F32(v)) for v in center)
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def _source_coords(minv: np.ndarray, width: int, height: int):
    """The float32 source coordinate of every destination pixel, as the
    AVX2 kernels compute it (see the module docstring)."""
    M = np.asarray(minv, np.float64).reshape(-1).astype(_F32)
    if M.size == 6:
        M = np.concatenate([M, np.array([0, 0, 1], _F32)])
    y = np.arange(height, dtype=_F32)[:, None]
    nv = (width // _VECTOR) * _VECTOR
    xv = np.arange(nv, dtype=_F32)[None, :]
    xt = np.arange(nv, width, dtype=_F32)[None, :]

    def row(k):
        vec = fma32(M[k], xv, y * M[k + 1] + M[k + 2])
        tail = fma32(xt, M[k], y * M[k + 1]) + M[k + 2]
        return np.concatenate([np.broadcast_to(vec, (height, nv)),
                               np.broadcast_to(tail, (height, width - nv))], 1)

    X, Y, W = row(0), row(3), row(6)
    with np.errstate(divide="ignore", invalid="ignore"):
        sx, sy = X / W, Y / W
    if not (np.isfinite(sx).all() and np.isfinite(sy).all()) or max(
            np.abs(sx).max(initial=0), np.abs(sy).max(initial=0)) >= 2 ** 30:
        raise ValueError("warp: the matrix maps a pixel to infinity or past ±2^30")
    return sx, sy


def _gather(img, yy, xx, border: str, value):
    """``img[yy, xx]`` (H, W, C) with off-image indices the border's."""
    h, w = img.shape[:2]
    v = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
    if border == BORDER_REPLICATE:
        return v
    inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    return np.where(inside[..., None], v, value)


def _channels_last(img: np.ndarray):
    squeeze = img.ndim == 2 or img.shape[2] == 1
    return (img.reshape(img.shape[0], img.shape[1], -1), squeeze)


def _border_value(value, channels: int, dtype):
    v = np.broadcast_to(np.asarray(value, np.float64).ravel()[:channels], (channels,))
    if dtype == np.uint8:
        return np.clip(np.rint(v), 0, 255).astype(np.uint8)
    return v.astype(dtype)


def warp_perspective_u8(img: np.ndarray, m, dsize, interp: str = INTER_LINEAR,
                        border: str = BORDER_CONSTANT, value=0) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) → ``cv2.warpPerspective(img, m, dsize,
    flags=..., borderMode=..., borderValue=value)`` (``dsize`` = (width,
    height)); a one-channel result is (height, width), as cv2's is.
    ``interp`` is ``"linear"`` or ``"nearest"``, ``border`` ``"constant"``
    or ``"replicate"`` (nearest takes constant only)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or img.size == 0:
        raise ValueError(f"a non-empty uint8 (H, W[, C]) image, got {img.dtype} {img.shape}")
    if interp not in (INTER_LINEAR, INTER_NEAREST) or border not in (BORDER_CONSTANT, BORDER_REPLICATE):
        raise ValueError(f"interp linear/nearest and border constant/replicate, got {interp}, {border}")
    if interp == INTER_NEAREST and border != BORDER_CONSTANT:
        raise ValueError("nearest warps are ported with BORDER_CONSTANT only")
    x, squeeze = _channels_last(img)
    width, height = int(dsize[0]), int(dsize[1])
    sx, sy = _source_coords(invert_3x3(m), width, height)
    bval = _border_value(value, x.shape[2], np.uint8)
    if interp == INTER_NEAREST:
        out = _gather(x, np.rint(sy).astype(np.int64), np.rint(sx).astype(np.int64), border, bval)
    else:
        ix, iy = np.floor(sx), np.floor(sy)
        a = (sx - ix).astype(_F32)[..., None]
        b = (sy - iy).astype(_F32)[..., None]
        ix, iy = ix.astype(np.int64), iy.astype(np.int64)
        p = [_gather(x, iy + dy, ix + dx, border, bval).astype(np.float64)
             for dy in (0, 1) for dx in (0, 1)]
        # a·(p1 − p0) + p0 of whole-number pixels is exact in float64, so
        # one rounding to float32 is the FMA's
        a = a.astype(np.float64)
        top = (a * (p[1] - p[0]) + p[0]).astype(_F32)
        bottom = (a * (p[3] - p[2]) + p[2]).astype(_F32)
        out = np.clip(np.rint(fma32(b, bottom - top, top)), 0, 255).astype(np.uint8)
    return out[..., 0] if squeeze else out


def warp_affine_f32(x: np.ndarray, m, dsize) -> np.ndarray:
    """float32 (H, W) → ``cv2.warpAffine(x, m, dsize)`` (``INTER_LINEAR``,
    ``BORDER_CONSTANT`` 0; ``m`` 2×3): the same coordinates and lerps as
    :func:`warp_perspective_u8`, kept in float32."""
    x = np.asarray(x)
    if x.dtype != _F32 or x.ndim != 2 or x.size == 0:
        raise ValueError(f"a non-empty float32 (H, W) array, got {x.dtype} {x.shape}")
    width, height = int(dsize[0]), int(dsize[1])
    sx, sy = _source_coords(invert_affine(m), width, height)
    ix, iy = np.floor(sx), np.floor(sy)
    a, b = (sx - ix).astype(_F32), (sy - iy).astype(_F32)
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    src = x[..., None]
    zero = np.zeros(1, _F32)
    p = [_gather(src, iy + dy, ix + dx, BORDER_CONSTANT, zero)[..., 0]
         for dy in (0, 1) for dx in (0, 1)]
    top = fma32(a, p[1] - p[0], p[0])
    bottom = fma32(a, p[3] - p[2], p[2])
    return fma32(b, bottom - top, top)


def _lerp32(src: np.ndarray, sx, sy, border: str, value) -> np.ndarray:
    """The bilinear sample of float32 (H, W) ``src`` at float32 (sx, sy), as
    the AVX2 kernels lerp (module docstring)."""
    ix, iy = np.floor(sx), np.floor(sy)
    a, b = (sx - ix).astype(_F32), (sy - iy).astype(_F32)
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    s = src[..., None]
    fill = np.array([value], src.dtype)
    p = [_gather(s, iy + dy, ix + dx, border, fill)[..., 0].astype(_F32)
         for dy in (0, 1) for dx in (0, 1)]
    top = fma32(a, p[1] - p[0], p[0])
    bottom = fma32(a, p[3] - p[2], p[2])
    return fma32(b, bottom - top, top)


def warp_affine_u8(img: np.ndarray, m, dsize, value: int = 0) -> np.ndarray:
    """uint8 (H, W) → ``cv2.warpAffine(img, m, dsize, flags=INTER_LINEAR,
    borderMode=BORDER_CONSTANT, borderValue=value)``: the affine inverse's
    coordinates and the lerps of :func:`warp_perspective_u8`, rounded half
    to even."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2 or img.size == 0:
        raise ValueError(f"a non-empty uint8 (H, W) image, got {img.dtype} {img.shape}")
    sx, sy = _source_coords(invert_affine(m), int(dsize[0]), int(dsize[1]))
    v = _lerp32(img, sx, sy, BORDER_CONSTANT, value)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def remap_linear_f32(x: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """float32 (H, W) → ``cv2.remap(x, map_x, map_y, cv2.INTER_LINEAR,
    borderMode=cv2.BORDER_REPLICATE)`` with float32 maps: each output the
    lerp of :func:`warp_perspective_u8` at its map coordinate."""
    x = np.asarray(x)
    if x.dtype != _F32 or x.ndim != 2 or x.size == 0:
        raise ValueError(f"a non-empty float32 (H, W) array, got {x.dtype} {x.shape}")
    return _lerp32(x, np.asarray(map_x, _F32), np.asarray(map_y, _F32), BORDER_REPLICATE, 0)
