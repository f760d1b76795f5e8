"""PyTorch port: the text-line detector (``ocr/torchocr/detector.py``) and the
learned textness head (``textness.py``) on the CPU against the JAX package.

Tolerance: the classical map (``_textness_map``) is bit-equal (its window
sums are exact in float32); textness logits are within 1e-5 of the largest
|logit|; ``detect_lines`` returns the JAX package's exact boxes, in order,
for every method; ``read_page`` returns the same boxes and texts, with
confidences within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twinvoice_tpu.data.synthetic import render_invoice
from twinvoice_tpu.ocr.jaxocr import detector as jdet
from twinvoice_tpu.ocr.jaxocr import textness as jtex
from twinvoice_tpu_torch.ocr.torchocr import detector as tdet
from twinvoice_tpu_torch.ocr.torchocr import textness as ttex

LOGIT_RTOL = 1e-5
CONF_ATOL = 1e-5
METHODS = ("classical", "learned", "hybrid", "auto")

# render_invoice pages: the first is the two-QR page of the JAX detector tests
PAGES = (
    dict(invoice_no="AB12345678", date_iso="2025-09-09", amount=543, seed=3),
    dict(invoice_no="QK80417265", date_iso="2024-12-31", amount=4580, seed=12,
         layout_jitter=0.5),
    dict(invoice_no="MN55120093", date_iso="2023-07-21", amount=12999, seed=14,
         layout_jitter=0.5, stylize=0.5),
    dict(invoice_no="ZX00992471", date_iso="2025-03-07", amount=36, seed=21,
         dot_print=True, size=(600, 380)),
)


@pytest.fixture(scope="module")
def pages():
    return [render_invoice(**kw)[0] for kw in PAGES]


def _int_boxes(boxes):
    return [tuple(int(v) for v in b) for b in boxes]


@pytest.mark.parametrize("shape", [(64, 64), (128, 320), (640, 448)])
def test_textness_map_bit_equal_random(shape):
    rng = np.random.default_rng(shape[1])
    for kind in ("uniform", "text-like"):
        if kind == "uniform":
            g = rng.integers(0, 256, (2,) + shape, dtype=np.uint8)
        else:
            g = np.where(rng.random((2,) + shape) < 0.08, rng.integers(0, 90),
                         rng.integers(170, 256)).astype(np.uint8)
        want = np.asarray(jdet._textness_map(jnp.asarray(g)))
        got = tdet._textness_map(torch.from_numpy(g)).numpy()
        np.testing.assert_array_equal(got, want)


def test_textness_map_bit_equal_on_pages(pages):
    for img in pages:
        arr = np.asarray(img.convert("L"))
        np.testing.assert_array_equal(tdet._classical_map(arr, "cpu"),
                                      jdet._classical_map(arr))


def test_load_textness_leaf_order():
    """``l0…l9``: each layer's bias (even) then kernel (odd), as jax.tree.leaves
    sorts the dict keys; the port's layers equal JAX's."""
    jp = jtex.load_textness()
    tp = ttex.load_textness()
    assert len(tp) == len(jp) == 5
    for t, j in zip(tp, jp):
        np.testing.assert_array_equal(
            t["weight"].numpy(), np.transpose(np.asarray(j["kernel"]), (3, 2, 0, 1)))
        np.testing.assert_array_equal(t["bias"].numpy(), np.asarray(j["bias"]))
    assert tuple(tp[0]["bias"].shape) == (16,) and tuple(tp[0]["weight"].shape) == (16, 1, 3, 3)
    assert ttex.load_textness("/nonexistent/textness.npz") is None


@pytest.mark.parametrize("hw", [(64, 64), (64, 192), (448, 640), (68, 100)])
def test_textness_apply_random_params(hw):
    """Random params through ``textness_params_from_jax``; odd SAME padding
    too (68×100: stride 2 over an even then an odd axis)."""
    rng = np.random.default_rng(hw[1])
    jp = jtex.init_textness(jax.random.key(hw[0]))
    jp = [{"kernel": np.asarray(p["kernel"]),
           "bias": rng.normal(0, 0.1, np.shape(p["bias"])).astype(np.float32)} for p in jp]
    x = rng.random((2,) + hw + (1,)).astype(np.float32)
    want = np.asarray(jax.jit(jtex.textness_apply)(jp, jnp.asarray(x)))[..., 0]
    with torch.inference_mode():
        got = ttex.textness_apply(ttex.textness_params_from_jax(jp),
                                  torch.from_numpy(x).permute(0, 3, 1, 2))[:, 0].numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LOGIT_RTOL * np.abs(want).max()


def test_textness_logits_bundled_on_pages(pages):
    jp, tp = jtex.load_textness(), ttex.load_textness()
    for img in pages:
        arr = np.asarray(img.convert("L"))
        want = jtex.textness_logits(arr, jp)
        got = ttex.textness_logits(arr, tp, device="cpu")
        assert got.shape == want.shape == arr.shape
        assert np.abs(got - want).max() <= LOGIT_RTOL * np.abs(want).max()
        np.testing.assert_array_equal(ttex.textness_map(arr, tp, device="cpu"),
                                      jtex.textness_map(arr, jp))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("page", range(len(PAGES)))
def test_detect_lines_equal_boxes(pages, method, page):
    img = pages[page]
    want = _int_boxes(jdet.detect_lines(img, method=method))
    got = tdet.detect_lines(img, method=method, device="cpu")
    assert got == want
    assert len(got) >= 3


def test_detect_lines_gray_rgb_and_blank():
    img = render_invoice(**PAGES[1])[0]
    rgb = np.asarray(img)
    assert tdet.detect_lines(rgb, method="classical", device="cpu") == _int_boxes(
        jdet.detect_lines(rgb, method="classical"))
    blank = np.full((320, 240), 250, np.uint8)
    assert tdet.detect_lines(blank, device="cpu") == jdet.detect_lines(blank) == []


def test_read_page_equal(pages):
    from twinvoice_tpu.ocr.jaxocr.engine import JaxOcrEngine

    je = JaxOcrEngine()
    te = tdet.shared_engine("cpu")
    assert te is tdet.shared_engine("cpu")
    for img in pages[:3]:
        want = jdet.read_page(img, je)
        got = tdet.read_page(img, te)
        assert [b for b, _ in got] == _int_boxes(b for b, _ in want)
        assert [r.text for _, r in got] == [r.text for _, r in want]
        for (_, g), (_, w) in zip(got, want):
            assert abs(g.confidence - w.confidence) <= CONF_ATOL
    joined = tdet.read_text(pages[0], te).replace("-", "").replace(" ", "")
    assert "AB12345678" in joined
    assert tdet.read_page(pages[0], te, boxes=[]) == []


def test_read_page_defaults_to_the_card(monkeypatch, pages):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdet.read_page(pages[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdet.detect_lines(pages[0])
