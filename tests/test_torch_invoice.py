"""PyTorch port: the invoice renderer (``data.synthetic.render_invoice``) and
the gauntlet's base cases (``eval.make_base_cases``) against the JAX
package's (Pillow and OpenCV, ``cv2.ipp.setUseIPP(False)``), byte for byte.

- ``render_invoice`` on the knob grid of ``scripts/make_torch_smoke_invoice.py``
  (the defaults, every face of both registries, layout jitter, stylize
  through both morphology branches, the cursor anchor, the dot-matrix print,
  other page sizes, CJK item names): pages and boxes;
- ``_draw_stylized_value``'s degenerate branch (no ink after the warp: the
  plain text drawn, the cursor box) and its tile pasted at the page edge;
- ``make_base_cases(3)`` for the three bases of ``eval_gauntlet.py``:
  images, masks, content and font names;
- ``Image.crop`` and ``convert`` against Pillow's, and a missing font
  raising with its path.
"""

import os
import sys

import cv2
import numpy as np
import pytest
from PIL import Image as PILImage

from twinvoice_tpu import FIELDS
from twinvoice_tpu.data import synthetic as J
from twinvoice_tpu.eval import gauntlet as JG
from twinvoice_tpu_torch.data import synthetic as P
from twinvoice_tpu_torch.eval import gauntlet as PG
from twinvoice_tpu_torch.ocr.fonts.truetype import FreeTypeFont
from twinvoice_tpu_torch.ops import host_pildraw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import make_torch_smoke_invoice as M  # noqa: E402


@pytest.fixture(autouse=True)
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def _paths(registry):
    return {os.path.basename(p): p for p in registry}


JAX_PATHS = _paths(J.train_fonts() + J.heldout_fonts())
PORT_PATHS = _paths(P.train_fonts() + P.heldout_fonts())


@pytest.mark.parametrize("i", range(len(M.grid())))
def test_render_invoice_knob_grid_equals_jax(i):
    kw = M.grid()[i]
    want, wboxes = J.render_invoice(**M.resolve(kw, JAX_PATHS))
    got, gboxes = P.render_invoice(**M.resolve(kw, PORT_PATHS))
    assert isinstance(got, host_pildraw.Image) and got.mode == "RGB"
    assert np.array_equal(np.asarray(got), np.asarray(want)), kw
    assert gboxes == wboxes, kw


def test_every_face_of_both_registries_is_in_the_grid():
    fonts = {kw["font"] for kw in M.grid() if "font" in kw}
    assert fonts == set(M.TRAIN_REGISTRY + M.HELDOUT_REGISTRY)
    here = set(JAX_PATHS) - fonts
    assert here == {"Minecraft.ttf", "sans.ttf"}  # the faces the card's machine lacks
    for name in sorted(here):
        want, wboxes = J.render_invoice(font_path=JAX_PATHS[name], font_size=21, seed=31)
        got, gboxes = P.render_invoice(font_path=PORT_PATHS[name], font_size=21, seed=31)
        assert np.array_equal(np.asarray(got), np.asarray(want)) and gboxes == wboxes, name


def test_stylized_value_degenerate_branch_and_page_edge():
    """A value with no ink after the transform (a space) falls back to the
    plain drawing and the cursor box; a value at the page's right edge pastes
    a clipped tile. Both also leave the generator in JAX's state."""
    from PIL import ImageFont

    path = JAX_PATHS["DejaVuSans.ttf"]
    for text, xy in ((" ", (40, 30)), ("AB-12345678", (300, 50))):
        base = np.full((120, 360, 3), 240, np.uint8)
        rj, rp = np.random.default_rng(9), np.random.default_rng(9)
        ij = PILImage.fromarray(base.copy())
        ip = host_pildraw.Image.fromarray(base.copy())
        bj = J._draw_stylized_value(ij, text, ImageFont.truetype(path, 22), xy, 26, rj, 1.0)
        bp = P._draw_stylized_value(ip, text, FreeTypeFont(PORT_PATHS["DejaVuSans.ttf"], 22),
                                    xy, 26, rp, 1.0)
        assert bp == bj and np.array_equal(ip.array, np.asarray(ij)), text
        assert rp.bit_generator.state == rj.bit_generator.state


@pytest.mark.parametrize("base", list(M.BASES))
def test_make_base_cases_equal_jax(base):
    kw = M.BASES[base]
    want = JG.make_base_cases(3, **kw)
    got = PG.make_base_cases(3, **kw)
    for w, g in zip(want, got):
        assert (g.invoice_no, g.date, g.amount, g.level, g.font) == (
            w.invoice_no, w.date, w.amount, w.level, w.font)
        assert np.array_equal(g.image, w.image) and np.array_equal(g.mask, w.mask)
    assert len(got) == 3 and got[0].mask.shape[-1] == len(FIELDS)


def test_crop_and_convert_are_pillows():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    pil, port = PILImage.fromarray(a), host_pildraw.Image.fromarray(a)
    for box in ((0, 0, 53, 37), (5, 7, 40, 30), (-4, -3, 20, 10), (30, 20, 70, 50),
                (10, 10, 10, 10)):
        assert np.array_equal(port.crop(box).array, np.asarray(pil.crop(box))), box
    assert np.array_equal(port.convert("L").array, np.asarray(pil.convert("L")))
    g = a[..., 0].copy()
    assert np.array_equal(host_pildraw.Image.fromarray(g).convert("RGB").array,
                          np.asarray(PILImage.fromarray(g).convert("RGB")))
    with pytest.raises(ValueError):
        port.crop((10, 0, 5, 5))


def test_missing_font_raises_with_its_path(tmp_path):
    path = str(tmp_path / "gone.ttf")
    with pytest.raises(FileNotFoundError, match="gone.ttf"):
        P.render_invoice(font_path=path)
