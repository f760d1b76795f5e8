"""PyTorch port: Pillow's drawing without Pillow (``ops/host_pildraw.py``)
against Pillow 12.1, byte for byte, on seeded cases.

- ``line`` at widths 0–12 with ``joint="curve"`` on "L" and "RGB" (an int
  ink on RGB is a packed pixel), float points off the image included: from
  width 5 Pillow adds a pie slice at each bend, from width 9 a 3-pixel line
  over the gap;
- filled ``ellipse`` and ``pieslice`` boxes of every small size, clipped at
  the edges, at seeded angles (multiples of 45° included);
- ``text`` and ``textlength`` with the port's TrueType fonts on "L" and
  "RGB" at float positions;
- ``Image.rotate`` (NEAREST, ``expand=True``, a fill colour) at seeded
  angles, ``resize`` (bicubic) and ``paste``.
"""

import numpy as np
import pytest
from PIL import Image as PilImage
from PIL import ImageDraw, ImageFont

from twinvoice_tpu.data.synthetic import train_fonts
from twinvoice_tpu_torch.ocr.fonts.truetype import FreeTypeFont
from twinvoice_tpu_torch.ops import host_pildraw as H


def _pair(mode, size, color):
    return PilImage.new(mode, size, color), H.Image.new(mode, size, color)


def _bg(mode, rng):
    return int(rng.integers(150, 256)) if mode == "L" else tuple(int(v) for v in rng.integers(150, 256, 3))


def _fill(mode, rng):
    return int(rng.integers(0, 256)) if mode == "L" else int(rng.integers(0, 1 << 24))


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("width", range(0, 13))
def test_lines_equal_pillow(mode, width):
    rng = np.random.default_rng(100 + width)
    for _ in range(40):
        w, h = int(rng.integers(8, 70)), int(rng.integers(8, 50))
        bg = _bg(mode, rng)
        pil, port = _pair(mode, (w, h), bg)
        pts = [(float(rng.uniform(-8, w + 8)), float(rng.uniform(-8, h + 8)))
               for _ in range(int(rng.integers(2, 6)))]
        if rng.random() < 0.2:
            pts = [pts[0], pts[0]]  # a zero-length segment is a point
        fill = _fill(mode, rng)
        ImageDraw.Draw(pil).line(pts, fill=fill, width=width, joint="curve")
        H.Draw(port).line(pts, fill=fill, width=width, joint="curve")
        assert np.array_equal(np.asarray(pil), port.array), (pts, width)


def test_flat_coordinates_and_rules_equal_pillow():
    """``line((x0, y0, x1, y1))``, the textness page's horizontal rules."""
    rng = np.random.default_rng(5)
    for _ in range(30):
        pil, port = _pair("RGB", (120, 40), (240, 240, 240))
        x, y = int(rng.integers(-5, 100)), int(rng.integers(0, 40))
        xy = (x, y, min(120, x + int(rng.integers(40, 200))), y)
        wd = int(rng.integers(1, 3))
        ImageDraw.Draw(pil).line(xy, fill=0, width=wd)
        H.Draw(port).line(xy, fill=0, width=wd)
        assert np.array_equal(np.asarray(pil), port.array), xy


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_ellipses_equal_pillow(mode):
    rng = np.random.default_rng(3)
    for a in range(0, 18):
        for b in range(0, 18, 3):
            pil, port = _pair(mode, (24, 24), _bg(mode, rng))
            x, y = int(rng.integers(-6, 12)), int(rng.integers(-6, 12))
            fill = _fill(mode, rng)
            ImageDraw.Draw(pil).ellipse((x, y, x + a, y + b), fill=fill)
            H.Draw(port).ellipse((x, y, x + a, y + b), fill=fill)
            assert np.array_equal(np.asarray(pil), port.array), (x, y, a, b)


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_pieslices_equal_pillow(mode):
    rng = np.random.default_rng(6)
    for i in range(300):
        pil, port = _pair(mode, (30, 30), _bg(mode, rng))
        x, y = int(rng.integers(-4, 18)), int(rng.integers(-4, 18))
        box = (x, y, x + int(rng.integers(0, 14)), y + int(rng.integers(0, 14)))
        if i % 5 == 0:
            start, end = float(rng.integers(-8, 9) * 45), float(rng.integers(-8, 9) * 45)
        else:
            start, end = float(rng.uniform(-400, 400)), float(rng.uniform(-400, 400))
        fill = _fill(mode, rng)
        ImageDraw.Draw(pil).pieslice(box, start, end, fill=fill)
        H.Draw(port).pieslice(box, start, end, fill=fill)
        assert np.array_equal(np.asarray(pil), port.array), (box, start, end)


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_text_equal_pillow(mode):
    rng = np.random.default_rng(8 if mode == "L" else 9)
    fonts = [f for f in train_fonts() if "DejaVu" in f]
    for i in range(24):
        path = fonts[i % len(fonts)]
        size = int(rng.integers(10, 30))
        pil_font, port_font = ImageFont.truetype(path, size), FreeTypeFont(path, size)
        pil, port = _pair(mode, (220, 60), _bg(mode, rng))
        text = "".join(rng.choice(list("0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ-./:,$#*() "), 9))
        xy = (float(rng.uniform(-6, 60)), float(rng.uniform(-6, 30)))
        fill = int(rng.integers(0, 100)) if i % 3 or mode == "L" else (10, 20, 30)
        pd, hd = ImageDraw.Draw(pil), H.Draw(port)
        pd.text(xy, text, fill=fill, font=pil_font)
        hd.text(xy, text, fill=fill, font=port_font)
        assert np.array_equal(np.asarray(pil), port.array), (path, size, text, xy)
        assert hd.textlength(text, font=port_font) == pd.textlength(text, font=pil_font)


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_rotate_resize_paste_equal_pillow(mode):
    rng = np.random.default_rng(21)
    for _ in range(30):
        h, w = int(rng.integers(3, 40)), int(rng.integers(3, 120))
        arr = rng.integers(0, 256, (h, w) if mode == "L" else (h, w, 3), np.uint8)
        fill = 255 if mode == "L" else (255, 250, 245)
        angle = float(rng.uniform(-8, 8))
        want = PilImage.fromarray(arr).rotate(angle, expand=True, fillcolor=fill)
        got = H.Image.fromarray(arr).rotate(angle, expand=True, fillcolor=fill)
        assert np.array_equal(np.asarray(want), got.array), angle
        size = (int(rng.integers(1, 260)), int(rng.integers(1, 40)))
        assert np.array_equal(np.asarray(want.resize(size)), got.resize(size).array), size
        pil, port = _pair(mode, (60, 30), fill)
        at = (int(rng.integers(-20, 60)), int(rng.integers(-10, 30)))
        pil.paste(want, at)
        port.paste(got, at)
        assert np.array_equal(np.asarray(pil), port.array), at
    for angle in (0.0, 90.0, 180.0, 270.0, -90.0):
        arr = rng.integers(0, 256, (5, 7) if mode == "L" else (5, 7, 3), np.uint8)
        want = PilImage.fromarray(arr).rotate(angle, expand=True, fillcolor=0)
        assert np.array_equal(np.asarray(want), H.Image.fromarray(arr).rotate(
            angle, expand=True, fillcolor=0).array), angle
