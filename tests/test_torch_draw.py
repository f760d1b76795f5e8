"""PyTorch port: ``ops.host_draw`` against OpenCV byte for byte: filled
rectangles and lines of thickness 1–7, with end points inside the frame and
up to 60 pixels outside it (the polygon and the clipping), horizontal and
vertical ones included."""

import cv2
import numpy as np
import pytest

from twinvoice_tpu_torch.ops.host_draw import fill_rect_u8, line_u8


def cases(seed, n):
    rng = np.random.default_rng(seed)
    for t in range(n):
        h, w = int(rng.integers(17, 161)), int(rng.integers(23, 225))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        color = tuple(int(v) for v in rng.integers(30, 225, 3))
        m = 60 if t % 2 else 0
        x1, x2 = (int(v) for v in rng.integers(-m, w + m, 2))
        y1, y2 = (int(v) for v in rng.integers(-m, h + m, 2))
        if t % 5 == 0:
            y2 = y1
        if t % 7 == 0:
            x2 = x1
        yield img, (x1, y1), (x2, y2), color


@pytest.mark.parametrize("thickness", range(1, 8))
def test_line_byte_equal(thickness):
    for img, p1, p2, color in cases(thickness, 120):
        want = cv2.line(img.copy(), p1, p2, color, thickness)
        got = line_u8(img.copy(), p1, p2, color, thickness)
        assert np.array_equal(got, want), (img.shape, p1, p2, thickness)


def test_line_on_one_channel():
    for img, p1, p2, _ in cases(9, 40):
        gray = img[..., 0].copy()
        assert np.array_equal(line_u8(gray.copy(), p1, p2, 200, 3), cv2.line(gray.copy(), p1, p2, 200, 3))


def test_fill_rect_byte_equal():
    for img, p1, p2, color in cases(8, 200):
        want = cv2.rectangle(img.copy(), p1, p2, color, -1)
        assert np.array_equal(fill_rect_u8(img.copy(), p1, p2, color), want), (p1, p2)
