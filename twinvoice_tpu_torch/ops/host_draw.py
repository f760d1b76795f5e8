"""Filled rectangles and lines on uint8 images, as OpenCV draws them.

The perturbation engine's clutter background (``data/augment.py``) draws
with ``cv2.rectangle(img, p1, p2, color, -1)`` and ``cv2.line(img, p1, p2,
color, thickness)`` (``LINE_8``, thickness 1–7). This module rasterizes the
same pixels with OpenCV's integer code (``imgproc/src/drawing.cpp``):

- a filled rectangle is the convex polygon of its four corners: every pixel
  between the corners, both ends included, clipped to the image;
- a line of thickness 1 is ``LineIterator``'s 8-connected Bresenham walk,
  left to right, after ``clipLine``;
- a thicker line is ``ThickLine``: the quadrilateral whose corners lie half
  the thickness off each end point in 16-bit fixed point (``XY_SHIFT``),
  filled by ``FillConvexPoly`` (edges walked in fixed point, each edge also
  drawn by ``Line2``), plus a filled ``Circle`` of radius ``(t + 1) // 2``
  at each end.

Every colour is written whole (one value a channel), so drawing order does
not matter: each function computes the pixel set and assigns it in place.
``tests/test_torch_draw.py`` holds both against ``cv2`` byte for byte.
"""

from __future__ import annotations

import math

import numpy as np

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _check(img: np.ndarray, color):
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"a uint8 (H, W) or (H, W, C) image, got {img.dtype} {img.shape}")
    channels = 1 if img.ndim == 2 else img.shape[2]
    color = np.broadcast_to(np.asarray(color, np.float64).ravel()[:channels], (channels,))
    return np.clip(np.rint(color), 0, 255).astype(np.uint8)


def _c_div(a: int, b: int) -> int:
    """C's integer division (the quotient truncated toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(width: int, height: int, p1, p2):
    """OpenCV's ``clipLine(Size, pt1, pt2)`` on int64 points: → the clipped
    points, or None when the segment misses the image."""
    right, bottom = width - 1, height - 1
    if width <= 0 or height <= 0:
        return None
    x1, y1 = p1
    x2, y2 = p2

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def _line_points(width: int, height: int, p1, p2):
    """``LineIterator(img, p1, p2, 8, leftToRight=true)``'s pixels (integer
    end points): → (xs, ys) lists."""
    if not (0 <= p1[0] < width and 0 <= p2[0] < width
            and 0 <= p1[1] < height and 0 <= p2[1] < height):
        clipped = _clip_line(width, height, p1, p2)
        if clipped is None:
            return [], []
        p1, p2 = clipped
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    delta_x = delta_y = 1
    if dx < 0:  # left to right: swap the ends
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    if dy < 0:
        dy, delta_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
        delta_x, delta_y = delta_y, delta_x
    err = dx - (dy + dy)
    plus_delta, minus_delta = dx + dx, -(dy + dy)
    # steps as (x, y): "minus" moves along the major axis, "plus" also
    # across it; the vertical case swaps which axis each moves
    minus = (delta_x, 0) if not vert else (0, delta_x)
    plus = (0, delta_y) if not vert else (delta_y, 0)
    xs, ys = [], []
    x, y = x1, y1
    for _ in range(dx + 1):
        xs.append(x)
        ys.append(y)
        if err < 0:
            err += minus_delta + plus_delta
            x += minus[0] + plus[0]
            y += minus[1] + plus[1]
        else:
            err += minus_delta
            x += minus[0]
            y += minus[1]
    return xs, ys


def _line2_points(width: int, height: int, p1, p2):
    """OpenCV's ``Line2``: the line between two ``XY_SHIFT`` fixed-point
    points (clipped against the scaled image size), stepped in fixed point
    along its major axis. → (xs, ys); points off the image are dropped by
    the caller."""
    clipped = _clip_line(width << _XY_SHIFT, height << _XY_SHIFT, p1, p2)
    if clipped is None:
        return [], []
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    if abs(dx) > abs(dy):
        if dx < 0:  # walk left to right
            x1, x2, y1, y2 = x2, x1, y2, y1
            dy = -dy
        x_step, y_step = _XY_ONE, _c_div(dy * _XY_ONE, abs(dx) | 1)
        ecount = (x2 - x1) >> _XY_SHIFT
    else:
        if dy < 0:  # walk top to bottom
            x1, x2, y1, y2 = x2, x1, y2, y1
            dx = -dx
        x_step, y_step = _c_div(dx * _XY_ONE, abs(dy) | 1), _XY_ONE
        ecount = (y2 - y1) >> _XY_SHIFT
    half = _XY_ONE >> 1
    xs = [(x2 + half) >> _XY_SHIFT]
    ys = [(y2 + half) >> _XY_SHIFT]
    x1 += half
    y1 += half
    if x_step == _XY_ONE:
        x = x1 >> _XY_SHIFT
        for _ in range(ecount + 1):
            xs.append(x)
            ys.append(y1 >> _XY_SHIFT)
            x += 1
            y1 += y_step
    else:
        y = y1 >> _XY_SHIFT
        for _ in range(ecount + 1):
            xs.append(x1 >> _XY_SHIFT)
            ys.append(y)
            x1 += x_step
            y += 1
    return xs, ys


def _fill_convex_poly(cover: np.ndarray, v):
    """OpenCV's ``FillConvexPoly(img, v, n, color, LINE_8, XY_SHIFT)``: marks
    in ``cover`` (bool (H, W)) the polygon's outline (``Line2`` on each edge)
    and its scan-line spans."""
    height, width = cover.shape
    npts = len(v)
    delta = _XY_ONE >> 1
    p0 = v[-1]
    for p in v:
        xs, ys = _line2_points(width, height, p0, p)
        _mark(cover, xs, ys)
        p0 = p
    xs_ = [p[0] for p in v]
    ys_ = [p[1] for p in v]
    ymin_raw = min(ys_)
    imin = ys_.index(ymin_raw)
    xmin = (min(xs_) + delta) >> _XY_SHIFT
    xmax = (max(xs_) + delta) >> _XY_SHIFT
    ymin = (ymin_raw + delta) >> _XY_SHIFT
    ymax = (max(ys_) + delta) >> _XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= width or ymin >= height:
        return
    ymax = min(ymax, height - 1)
    edges = npts
    edge = [dict(idx=imin, di=1, x=-_XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=npts - 1, x=-_XY_ONE, dx=0, ye=ymin)]
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0, di = e["idx"], e["di"]
                idx = (idx0 + di) % npts
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> _XY_SHIFT
                    if ty > y:
                        xs0, xe0 = v[idx0][0], v[idx][0]
                        e["ye"] = ty
                        e["dx"] = _c_div((xe0 - xs0) * 2 + (ty - y), 2 * (ty - y))
                        e["x"] = xs0
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx = (idx + di) % npts
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            x1 = (edge[left]["x"] + delta) >> _XY_SHIFT
            x2 = (edge[right]["x"] + delta) >> _XY_SHIFT
            if x2 >= 0 and x1 < width:
                cover[y, max(x1, 0):min(x2, width - 1) + 1] = True
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _fill_circle(cover: np.ndarray, cx: int, cy: int, radius: int):
    """OpenCV's filled ``Circle(img, center, radius, color, 1)``: the
    midpoint walk's horizontal spans, clipped to the image."""
    height, width = cover.shape
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for yy, xa, xb in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                           (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            if 0 <= yy < height and xa < width and xb >= 0:
                cover[yy, max(xa, 0):min(xb, width - 1) + 1] = True
        dy += 1
        err += plus
        plus += 2
        mask = (0 if err <= 0 else -1)
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _mark(cover: np.ndarray, xs, ys):
    if not xs:
        return
    xs, ys = np.asarray(xs, np.int64), np.asarray(ys, np.int64)
    h, w = cover.shape
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    cover[ys[ok], xs[ok]] = True


def fill_rect_u8(img: np.ndarray, p1, p2, color) -> np.ndarray:
    """``cv2.rectangle(img, p1, p2, color, -1)`` in place: every pixel with x
    between ``p1[0]`` and ``p2[0]`` and y between ``p1[1]`` and ``p2[1]``,
    both ends included, clipped to the image. Returns ``img``."""
    c = _check(img, color)
    h, w = img.shape[:2]
    (x1, y1), (x2, y2) = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    xa, xb = max(min(x1, x2), 0), min(max(x1, x2), w - 1)
    ya, yb = max(min(y1, y2), 0), min(max(y1, y2), h - 1)
    if xa <= xb and ya <= yb:
        img[ya:yb + 1, xa:xb + 1] = c if img.ndim == 3 else c[0]
    return img


def line_u8(img: np.ndarray, p1, p2, color, thickness: int = 1) -> np.ndarray:
    """``cv2.line(img, p1, p2, color, thickness)`` (``LINE_8``, integer end
    points anywhere, even off the image) in place. Returns ``img``."""
    c = _check(img, color)
    thickness = int(thickness)
    if not 0 < thickness <= 32767:
        raise ValueError(f"thickness in 1..32767, got {thickness}")
    h, w = img.shape[:2]
    cover = np.zeros((h, w), bool)
    p0 = (int(p1[0]), int(p1[1]))
    q0 = (int(p2[0]), int(p2[1]))
    if thickness == 1:
        _mark(cover, *_line_points(w, h, p0, q0))
    else:
        # OpenCV 5 first clips the segment to the image grown by the
        # thickness on every side (``clipLine`` on that rectangle)
        t = thickness
        clipped = _clip_line(w + 2 * t, h + 2 * t, (p0[0] + t, p0[1] + t),
                             (q0[0] + t, q0[1] + t))
        if clipped is None:
            return img
        (ax_, ay_), (bx_, by_) = clipped
        p0, q0 = (ax_ - t, ay_ - t), (bx_ - t, by_ - t)
        a = (p0[0] << _XY_SHIFT, p0[1] << _XY_SHIFT)
        b = (q0[0] << _XY_SHIFT, q0[1] << _XY_SHIFT)
        dx = (a[0] - b[0]) * (1.0 / _XY_ONE)
        dy = (b[1] - a[1]) * (1.0 / _XY_ONE)
        r = dx * dx + dy * dy
        odd = thickness & 1
        half = thickness << (_XY_SHIFT - 1)
        if math.fabs(r) > np.finfo(np.float64).eps:
            r = (half + odd * _XY_ONE * 0.5) / math.sqrt(r)
            ddx, ddy = int(np.rint(dy * r)), int(np.rint(dx * r))
            _fill_convex_poly(cover, [(a[0] + ddx, a[1] + ddy), (a[0] - ddx, a[1] - ddy),
                                      (b[0] - ddx, b[1] - ddy), (b[0] + ddx, b[1] + ddy)])
        radius = (half + (_XY_ONE >> 1)) >> _XY_SHIFT
        for end in (p0, q0):
            _fill_circle(cover, end[0], end[1], radius)
    img[cover] = c if img.ndim == 3 else c[0]
    return img
