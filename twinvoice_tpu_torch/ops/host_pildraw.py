"""Pillow's ``Image`` and ``ImageDraw`` for the training renderers, on numpy
arrays, without Pillow.

The recognizer's lines and the textness head's pages are drawn with
Pillow 12.1 (``twinvoice_tpu/ocr/jaxocr/data.py``, ``textness.py``). This
module draws the same pixels, following Pillow's C drawing code
(``libImaging/Draw.c``, ``Paste.c``, ``Geometry.c``) and its Python layer:

- :class:`Image`: modes ``"L"`` (H, W) and ``"RGB"`` (H, W, 3) uint8 in
  ``.array``;
  ``new``, ``crop`` (zeros outside), ``convert`` (``"L"`` as Pillow's
  luma, ``"RGB"``), ``paste`` (clipped copy), ``rotate`` (NEAREST, Pillow's default:
  the inverse affine matrix in 16.16 fixed point, ``affine_fixed``),
  ``resize`` (Pillow's default bicubic, :func:`host_image.resize_pil_bicubic`);
- :class:`Draw`: ``line`` (a 1-pixel Bresenham walk without its end point,
  the last point drawn apart; wider lines as ``ImagingDrawWideLine``'s
  quadrilateral filled by ``polygon_generic``, float32 edge crossings,
  spans from round-half-up to round-half-down; ``joint="curve"`` adds
  Pillow's pie slices at the bends of lines wider than 4), ``ellipse``
  (filled, by ``ellipseNew``'s quarter walk), ``pieslice`` (filled: the
  same walk clipped by half-planes, ``pieSliceNew``), ``text`` (the mask of
  :class:`ocr.fonts.truetype.FreeTypeFont` blended through ``fill_mask``:
  ``(ink·m + out·(255 − m)) / 255`` with Pillow's rounded division) and
  ``textlength``; with no font, both take Pillow's default font
  (``truetype.load_default()``, as ``ImageDraw.getfont`` does).

An int ink on an RGB image is a packed pixel (``r | g << 8 | b << 16``), as
Pillow's ``getink`` reads it. ``tests/test_torch_pildraw.py`` holds each
against Pillow byte for byte.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

from twinvoice_tpu_torch.ops.host_image import pil_luma, resize_pil_bicubic

_F32 = np.float32


class Image:
    """An "L" or "RGB" image on a uint8 array, ``.array``."""

    def __init__(self, array: np.ndarray, mode: str):
        if mode not in ("L", "RGB"):
            raise ValueError(f"mode {mode!r}: only 'L' and 'RGB' are drawn")
        array = np.ascontiguousarray(array, np.uint8)
        if (mode == "L") != (array.ndim == 2) or (mode == "RGB" and array.shape[2:] != (3,)):
            raise ValueError(f"a {mode} image needs (H, W{'' if mode == 'L' else ', 3'}), "
                             f"got {array.shape}")
        self.array = array
        self.mode = mode

    @classmethod
    def new(cls, mode: str, size: Tuple[int, int], color=0) -> "Image":
        w, h = size
        shape = (h, w) if mode == "L" else (h, w, 3)
        img = cls(np.zeros(shape, np.uint8), mode)
        img.array[...] = _ink(mode, color)
        return img

    @classmethod
    def fromarray(cls, array: np.ndarray) -> "Image":
        return cls(array, "L" if array.ndim == 2 else "RGB")

    def __array__(self, dtype=None, copy=None):
        """``np.asarray(img)``: the pixels, as of a PIL image."""
        return self.array if dtype is None else self.array.astype(dtype)

    @property
    def size(self) -> Tuple[int, int]:
        return self.array.shape[1], self.array.shape[0]

    @property
    def width(self) -> int:
        return self.array.shape[1]

    @property
    def height(self) -> int:
        return self.array.shape[0]

    def copy(self) -> "Image":
        return Image(self.array.copy(), self.mode)

    def crop(self, box) -> "Image":
        """``Image.crop((left, upper, right, lower))``: the box's pixels,
        zeros where it reaches outside the image."""
        x0, y0, x1, y1 = (int(round(v)) for v in box)
        if x1 < x0:
            raise ValueError("Coordinate 'right' is less than 'left'")
        if y1 < y0:
            raise ValueError("Coordinate 'lower' is less than 'upper'")
        out = Image.new(self.mode, (x1 - x0, y1 - y0), 0)
        out.paste(self, (-x0, -y0))
        return out

    def convert(self, mode: str) -> "Image":
        """``Image.convert("L")`` (Pillow's luma, ``host_image.pil_luma``)
        or ``convert("RGB")`` (the gray level in each channel)."""
        if mode == self.mode:
            return self.copy()
        if mode == "L":
            return Image(pil_luma(self.array), "L")
        if mode == "RGB":
            return Image(np.repeat(self.array[..., None], 3, axis=2), "RGB")
        raise ValueError(f"mode {mode!r}: only 'L' and 'RGB' are drawn")

    def paste(self, im: "Image", box: Tuple[int, int]) -> None:
        """``Image.paste(im, (x, y))``: a copy clipped to this image."""
        x, y = int(box[0]), int(box[1])
        src = im.array
        h, w = src.shape[:2]
        x0, y0 = max(x, 0), max(y, 0)
        x1, y1 = min(x + w, self.width), min(y + h, self.height)
        if x1 > x0 and y1 > y0:
            self.array[y0:y1, x0:x1] = src[y0 - y:y1 - y, x0 - x:x1 - x]

    def resize(self, size: Tuple[int, int]) -> "Image":
        """``Image.resize(size)`` with Pillow's default bicubic filter."""
        w, h = size
        if (w, h) == self.size:
            return self.copy()
        a = self.array if self.mode == "RGB" else self.array[..., None]
        out = resize_pil_bicubic(a, w, h)
        return Image(out if self.mode == "RGB" else out[..., 0], self.mode)

    def rotate(self, angle: float, expand: bool = False, fillcolor=None) -> "Image":
        """``Image.rotate(angle, expand=expand, fillcolor=fillcolor)`` with
        the default NEAREST filter."""
        angle = angle % 360.0
        if angle == 0:
            return self.copy()
        if angle == 180:
            return Image(self.array[::-1, ::-1].copy(), self.mode)
        if angle in (90, 270) and (expand or self.width == self.height):
            k = 1 if angle == 90 else 3
            return Image(np.ascontiguousarray(np.rot90(self.array, k)), self.mode)
        w, h = self.size
        center = (w / 2, h / 2)
        a = -math.radians(angle)
        matrix = [round(math.cos(a), 15), round(math.sin(a), 15), 0.0,
                  round(-math.sin(a), 15), round(math.cos(a), 15), 0.0]

        def transform(x, y, m):
            return m[0] * x + m[1] * y + m[2], m[3] * x + m[4] * y + m[5]

        matrix[2], matrix[5] = transform(-center[0], -center[1], matrix)
        matrix[2] += center[0]
        matrix[5] += center[1]
        if expand:
            xx, yy = [], []
            for x, y in ((0, 0), (w, 0), (w, h), (0, h)):
                tx, ty = transform(x, y, matrix)
                xx.append(tx)
                yy.append(ty)
            nw = math.ceil(max(xx)) - math.floor(min(xx))
            nh = math.ceil(max(yy)) - math.floor(min(yy))
            matrix[2], matrix[5] = transform(-(nw - w) / 2.0, -(nh - h) / 2.0, matrix)
            w, h = nw, nh
        out = Image.new(self.mode, (w, h), 0 if fillcolor is None else fillcolor)
        _affine_nearest(out.array, self.array, matrix)
        return out


def _fix16(v: float) -> int:
    v = v * 65536.0 + 0.5
    return int(math.floor(v)) if v < 0.0 else int(v)


def _affine_nearest(out: np.ndarray, src: np.ndarray, a) -> None:
    """Pillow's ``affine_fixed``: 16.16 steps along each output row; pixels
    whose source falls outside keep ``out``'s fill."""
    h, w = out.shape[:2]
    sh, sw = src.shape[:2]
    a0, a1, a3, a4 = _fix16(a[0]), _fix16(a[1]), _fix16(a[3]), _fix16(a[4])
    a2 = _fix16(a[2] + a[0] * 0.5 + a[1] * 0.5)
    a5 = _fix16(a[5] + a[3] * 0.5 + a[4] * 0.5)
    y = np.arange(h, dtype=np.int64)[:, None]
    x = np.arange(w, dtype=np.int64)[None, :]
    xx = ((a2 + y * a1 + x * a0) & 0xFFFFFFFF).astype(np.uint32).view(np.int32) >> 16
    yy = ((a5 + y * a4 + x * a3) & 0xFFFFFFFF).astype(np.uint32).view(np.int32) >> 16
    ok = (xx >= 0) & (xx < sw) & (yy >= 0) & (yy < sh)
    out[ok] = src[yy[ok], xx[ok]]


def _ink(mode: str, fill):
    """Pillow's ``getink``: an int is clipped on "L" and a packed pixel on
    "RGB"; a tuple gives the channels."""
    if mode == "L":
        if isinstance(fill, (tuple, list)):
            fill = fill[0]
        return np.uint8(min(max(int(fill), 0), 255))
    if isinstance(fill, (tuple, list)):
        return np.array([int(c) for c in fill[:3]], np.uint8)
    v = int(fill)
    return np.array([v & 255, (v >> 8) & 255, (v >> 16) & 255], np.uint8)


def _roundf(f) -> float:
    """C's ``roundf``: half away from zero."""
    f = float(f)
    return math.floor(f + 0.5) if f >= 0.0 else -math.floor(-f + 0.5)


def _round_up(f) -> int:
    f = float(f)
    return int(math.floor(f + 0.5)) if f >= 0.0 else -int(math.floor(abs(f) + 0.5))


def _round_down(f) -> int:
    f = float(f)
    return int(math.ceil(f - 0.5)) if f >= 0.0 else -int(math.ceil(abs(f) - 0.5))


class _Edge:
    __slots__ = ("x0", "y0", "xmin", "xmax", "ymin", "ymax", "dx")

    def __init__(self, x0, y0, x1, y1):
        self.xmin, self.xmax = (x0, x1) if x0 <= x1 else (x1, x0)
        self.ymin, self.ymax = (y0, y1) if y0 <= y1 else (y1, y0)
        self.dx = _F32(0.0) if y0 == y1 else _F32(x1 - x0) / _F32(y1 - y0)
        self.x0, self.y0 = x0, y0

    def x_at(self, y):
        return _F32(y - self.y0) * self.dx + _F32(self.x0)


class Draw:
    """``ImageDraw.Draw(image)`` for the calls the renderers make."""

    def __init__(self, image: Image):
        self.im = image
        self.a = image.array

    # -- pixels
    def _hline(self, x0: int, y: int, x1: int, ink) -> None:
        h, w = self.a.shape[:2]
        if 0 <= y < h:
            if x0 < 0:
                x0 = 0
            elif x0 >= w:
                return
            if x1 < 0:
                return
            if x1 >= w:
                x1 = w - 1
            if x0 <= x1:
                self.a[y, x0:x1 + 1] = ink

    def _point(self, x: int, y: int, ink) -> None:
        h, w = self.a.shape[:2]
        if 0 <= x < w and 0 <= y < h:
            self.a[y, x] = ink

    def _line1(self, x0, y0, x1, y1, ink) -> None:
        """Pillow's ``line8``/``line32``: the walk stops before (x1, y1)."""
        dx, dy = x1 - x0, y1 - y0
        xs = -1 if dx < 0 else 1
        ys = -1 if dy < 0 else 1
        dx, dy = abs(dx), abs(dy)
        if dx == 0:
            for _ in range(dy):
                self._point(x0, y0, ink)
                y0 += ys
        elif dy == 0:
            for _ in range(dx):
                self._point(x0, y0, ink)
                x0 += xs
        elif dx > dy:
            n = dx
            dy += dy
            e = dy - dx
            dx += dx
            for _ in range(n):
                self._point(x0, y0, ink)
                if e >= 0:
                    y0 += ys
                    e -= dx
                e += dy
                x0 += xs
        else:
            n = dy
            dx += dx
            e = dx - dy
            dy += dy
            for _ in range(n):
                self._point(x0, y0, ink)
                if e >= 0:
                    x0 += xs
                    e -= dy
                e += dx
                y0 += ys

    def _polygon(self, edges, ink) -> None:
        """Pillow's ``polygon_generic`` (no alpha, non-even-odd)."""
        h = self.a.shape[0]
        ymin, ymax = h - 1, 0
        table = []
        for e in edges:
            ymin = min(ymin, e.ymin)
            ymax = max(ymax, e.ymax)
            if e.ymin == e.ymax:
                self._hline(e.xmin, e.ymin, e.xmax, ink)
                continue
            table.append(e)
        ymin = max(ymin, 0)
        ymax = min(ymax, h)
        for y in range(ymin, ymax + 1):
            xx = []
            for i, cur in enumerate(table):
                if not (cur.ymin <= y <= cur.ymax):
                    continue
                xx.append(cur.x_at(y))
                if y == cur.ymax and y < ymax:
                    xx.append(xx[-1])
                elif cur.dx != 0 and len(xx) % 2 == 1 and _roundf(xx[-1]) == xx[-1]:
                    for k in range(i):
                        other = table[k]
                        if (cur.dx > 0 and other.dx <= 0) or (cur.dx < 0 and other.dx >= 0):
                            continue
                        if _roundf(xx[-1]) == _roundf(other.x_at(y)):
                            off = -1 if y == ymax else 1
                            adj = cur.x_at(y + off)
                            adj_other = other.x_at(y + off)
                            if (adj < xx[-1] < adj_other) or (adj > xx[-1] > adj_other):
                                xx.append(xx[-1])
                            break
            xx.sort()
            for i in range(1, len(xx), 2):
                self._hline(_round_up(xx[i - 1]), y, _round_down(xx[i]), ink)

    def _wide_line(self, x0, y0, x1, y1, ink, width: int) -> None:
        dx, dy = x1 - x0, y1 - y0
        if dx == 0 and dy == 0:
            self._point(x0, y0, ink)
            return
        big = math.hypot(dx, dy)
        small = (width - 1) / 2.0
        ratio_max = _round_up(small) / big
        ratio_min = _round_down(small) / big
        dxmin, dxmax = _round_down(ratio_min * dy), _round_down(ratio_max * dy)
        dymin, dymax = _round_down(ratio_min * dx), _round_down(ratio_max * dx)
        v = [(x0 - dxmin, y0 + dymax), (x1 - dxmin, y1 + dymax),
             (x1 + dxmax, y1 - dymin), (x0 + dxmax, y0 - dymin)]
        edges = [_Edge(*v[i], *v[(i + 1) % 4]) for i in range(4)]
        self._polygon(edges, ink)

    # -- the ImageDraw calls
    def line(self, xy: Sequence, fill=None, width: int = 0, joint=None) -> None:
        ink = _ink(self.im.mode, 0 if fill is None else fill)
        pts = [tuple(p) for p in xy] if isinstance(xy[0], (tuple, list)) else \
            [tuple(xy[i:i + 2]) for i in range(0, len(xy), 2)]
        ipts = [(int(x), int(y)) for x, y in pts]
        if width <= 1:
            for (ax, ay), (bx, by) in zip(ipts[:-1], ipts[1:]):
                self._line1(ax, ay, bx, by, ink)
            if len(ipts) > 1:
                self._point(ipts[-1][0], ipts[-1][1], ink)
        else:
            for (ax, ay), (bx, by) in zip(ipts[:-1], ipts[1:]):
                self._wide_line(ax, ay, bx, by, ink, width)
        if joint == "curve" and width > 4:
            self._joints(pts, fill, width)

    def _joints(self, points, fill, width: int) -> None:
        """``ImageDraw.line``'s curve joints (Pillow's Python, verbatim): a
        pie slice at each bend, and for widths over 8 a 3-pixel line over
        the gap between it and the segments."""
        for i in range(1, len(points) - 1):
            point = points[i]
            angles = [math.degrees(math.atan2(end[0] - start[0], start[1] - end[1])) % 360
                      for start, end in ((points[i - 1], point), (point, points[i + 1]))]
            if angles[0] == angles[1]:
                continue

            def coord_at_angle(coord, angle):
                x, y = coord
                angle -= 90
                distance = width / 2 - 1
                return tuple(p + (math.floor(p_d) if p_d > 0 else math.ceil(p_d))
                             for p, p_d in ((x, distance * math.cos(math.radians(angle))),
                                            (y, distance * math.sin(math.radians(angle)))))

            flipped = ((angles[1] > angles[0] and angles[1] - 180 > angles[0])
                       or (angles[1] < angles[0] and angles[1] + 180 > angles[0]))
            coords = [(point[0] - width / 2 + 1, point[1] - width / 2 + 1),
                      (point[0] + width / 2 - 1, point[1] + width / 2 - 1)]
            if flipped:
                start, end = (angles[1] + 90, angles[0] + 90)
            else:
                start, end = (angles[0] - 90, angles[1] - 90)
            self.pieslice(coords, start - 90, end - 90, fill)
            if width > 8:
                if flipped:
                    gap = [coord_at_angle(point, angles[0] + 90), point,
                           coord_at_angle(point, angles[1] + 90)]
                else:
                    gap = [coord_at_angle(point, angles[0] - 90), point,
                           coord_at_angle(point, angles[1] - 90)]
                self.line(gap, fill, width=3)

    def ellipse(self, xy, fill=None) -> None:
        """A filled ellipse in the box ``xy`` (Pillow's ``ellipseNew``)."""
        (x0, y0), (x1, y1) = _box(xy)
        if x1 < x0 or y1 < y0:
            raise ValueError("x1 must be greater than or equal to x0")
        ink = _ink(self.im.mode, 0 if fill is None else fill)
        a, b = x1 - x0, y1 - y0
        for X0, Y, X1 in _ellipse_spans(a, b, a + b):
            self._hline(x0 + (X0 + a) // 2, y0 + (Y + b) // 2, x0 + (X1 + a) // 2, ink)

    def pieslice(self, xy, start: float, end: float, fill=None) -> None:
        """A filled pie slice of the ellipse in the box ``xy`` from ``start``
        to ``end`` degrees, clockwise from 3 o'clock (Pillow's
        ``pieSliceNew``: the ellipse's spans clipped by the two edges'
        half-planes, and a third against spikes under 90°)."""
        (x0, y0), (x1, y1) = _box(xy)
        if x1 < x0:
            raise ValueError("x1 must be greater than or equal to x0")
        ink = _ink(self.im.mode, 0 if fill is None else fill)
        al, ar = _normalize_angles(start, end)
        a, b = x1 - x0, y1 - y0
        if al + 360 == ar:
            self.ellipse(xy, fill)
            return
        if al == ar or a < 0 or b < 0:
            return
        al, ar = float(al), float(ar)
        xl, yl = a * math.cos(al * math.pi / 180.0), b * math.sin(al * math.pi / 180.0)
        xr, yr = a * math.cos(ar * math.pi / 180.0), b * math.sin(ar * math.pi / 180.0)
        root = ("and" if ar - al < 180 else "or", ("clip", -yl, xl), ("clip", yr, -xr))
        if ar - al < 90:
            root = ("and", root, ("clip", (xl + xr) / 2.0, (yl + yr) / 2.0))
        for X0, Y, X1 in _ellipse_spans(a, b, a + b):
            ev = _clip_runs(root, X0, Y, X1)
            for k in range(0, len(ev) - 1, 2):
                self._hline(x0 + (ev[k][0] + a) // 2, y0 + (Y + b) // 2,
                            x0 + (ev[k + 1][0] + a) // 2, ink)

    def text(self, xy, text: str, fill=None, font=None) -> None:
        """``ImageDraw.text(xy, text, fill=fill, font=font)`` in mode "L"
        masks with the default anchor "la"."""
        if font is None:
            font = _default_font()
        ink = _ink(self.im.mode, 0 if fill is None else fill)
        coord = [int(xy[0]), int(xy[1])]
        start = (math.modf(xy[0])[0], math.modf(xy[1])[0])
        mask, offset = font.getmask2(text, start)
        self.draw_bitmap((coord[0] + offset[0], coord[1] + offset[1]), mask, ink)

    def draw_bitmap(self, xy, mask: np.ndarray, ink) -> None:
        """Pillow's ``ImagingFill2``: blend ``ink`` through ``mask`` at
        ``xy``, clipped; ``(ink·m + out·(255 − m) + 128)`` over 255 by
        Pillow's ``DIV255``."""
        x, y = int(xy[0]), int(xy[1])
        h, w = mask.shape
        H, W = self.a.shape[:2]
        x0, y0 = max(x, 0), max(y, 0)
        x1, y1 = min(x + w, W), min(y + h, H)
        if x1 <= x0 or y1 <= y0:
            return
        m = mask[y0 - y:y1 - y, x0 - x:x1 - x].astype(np.uint32)
        out = self.a[y0:y1, x0:x1]
        if out.ndim == 3:
            m = m[..., None]
        tmp = out.astype(np.uint32) * (255 - m) + np.asarray(ink, np.uint32) * m + 128
        out[...] = (((tmp >> 8) + tmp) >> 8).astype(np.uint8)

    def textlength(self, text: str, font=None) -> float:
        if font is None:
            font = _default_font()
        return font.getlength(text)


def _default_font():
    """Pillow's default font, as ``ImageDraw`` takes it when none is given."""
    from twinvoice_tpu_torch.ocr.fonts.truetype import load_default

    return load_default()


def _box(xy):
    """Pillow's coordinate flattening of a box, then ``(int)`` of each."""
    if isinstance(xy[0], (tuple, list)):
        (a, b), (c, d) = xy
    else:
        a, b, c, d = xy
    return (int(a), int(b)), (int(c), int(d))


# --------------------------------------------------- ellipse (ellipseNew)

class _Quarter:
    """Pillow's ``quarter_state``: one quarter of the ellipse in doubled
    coordinates, walked by the least deviation from the curve."""

    def __init__(self, a: int, b: int):
        self.finished = a < 0 or b < 0
        if not self.finished:
            self.a, self.b = a, b
            self.cx, self.cy = a, b % 2
            self.ex, self.ey = a % 2, b
            self.a2, self.b2 = a * a, b * b
            self.a2b2 = self.a2 * self.b2

    def delta(self, x, y):
        return abs(self.a2 * y * y + self.b2 * x * x - self.a2b2)

    def next(self):
        if self.finished:
            return None
        ret = (self.cx, self.cy)
        if self.cx == self.ex and self.cy == self.ey:
            self.finished = True
        else:
            nx, ny = self.cx, self.cy + 2
            nd = self.delta(nx, ny)
            if nx > 1:
                d = self.delta(self.cx - 2, self.cy + 2)
                if nd > d:
                    nx, ny, nd = self.cx - 2, self.cy + 2, d
                d = self.delta(self.cx - 2, self.cy)
                if nd > d:
                    nx, ny = self.cx - 2, self.cy
            self.cx, self.cy = nx, ny
        return ret


def _ellipse_spans(a: int, b: int, w: int):
    """Pillow's ``ellipse_init``/``ellipse_next``: → (x0, y, x1) spans in
    doubled coordinates centred on the box."""
    leftmost = a % 2
    outer = _Quarter(a, b)
    first = outer.next()
    if w < 1 or first is None:
        return
    pr, py = first
    inner = _Quarter(a - 2 * (w - 1), b - 2 * (w - 1))
    pl = leftmost
    finished = False
    while not finished:
        y, l, r = py, pl, pr
        nxt = outer.next()
        while nxt is not None and nxt[1] <= y:
            nxt = outer.next()
        if nxt is None:
            finished = True
        else:
            pr, py = nxt
        nxt = inner.next()
        while nxt is not None and nxt[1] <= y:
            l = nxt[0]
            nxt = inner.next()
        pl = leftmost if nxt is None else nxt[0]
        buf = []
        if (l > 0 or l < r) and y > 0:
            buf.append((2 if l == 0 else l, y, r))
        if y > 0:
            buf.append((-r, y, -l))
        if l > 0 or l < r:
            buf.append((2 if l == 0 else l, -y, r))
        buf.append((-r, -y, -l))
        for s in reversed(buf):
            yield s


def _normalize_angles(al, ar):
    """Pillow's ``normalize_angles`` on C floats: 0 ≤ al < 360, al ≤ ar ≤
    al + 360."""
    al, ar = _F32(al), _F32(ar)
    if ar - al >= 360:
        return _F32(0), _F32(360)
    al = _F32(math.fmod(360 - math.fmod(-float(al), 360) if al < 0 else float(al), 360))
    d = 360 - math.fmod(float(al) - float(ar), 360) if ar < al else float(ar) - float(al)
    return al, _F32(float(al) + math.fmod(d, 360))


def _lround(v: float) -> int:
    """C's ``lround``: half away from zero."""
    return int(math.floor(v + 0.5)) if v >= 0 else -int(math.floor(-v + 0.5))


def _clip_runs(node, x0: int, y: int, x1: int):
    """Pillow's ``clip_tree_do_clip``: the runs of the span [x0, x1] on row
    ``y`` (doubled coordinates) inside the clip tree, as (start, +1) and
    (end, −1) events. A leaf ``("clip", A, B)`` keeps ``A·x + B·y ≥ 0``;
    ``"and"``/``"or"`` merge their children's events."""
    kind = node[0]
    if kind == "clip":
        _, A, B = node
        eps = 1e-9
        if abs(A) < eps:
            if B * y < -eps:
                x0, x1 = 1, 0
        else:
            ix = -(B * y) / A
            if A * x0 + B * y < eps:
                x0 = _lround(max(x0, ix))
            if A * x1 + B * y < eps:
                x1 = _lround(min(x1, ix))
        return [(x0, 1), (x1, -1)] if x0 <= x1 else []
    l1, l2 = _clip_runs(node[1], x0, y, x1), _clip_runs(node[2], x0, y, x1)
    inside = 1 if kind == "or" else 2  # events active for a point to be in
    out, k, i, j = [], 0, 0, 0
    while i < len(l1) or j < len(l2):
        if j >= len(l2) or (i < len(l1) and (l1[i][0] < l2[j][0] or
                                             (l1[i][0] == l2[j][0] and l1[i][1] > l2[j][1]))):
            t = l1[i]
            i += 1
        else:
            t = l2[j]
            j += 1
        if (t[1] == 1 and k == inside - 1) or (t[1] == -1 and k == inside):
            out.append(t)
        k += t[1]
    return out
