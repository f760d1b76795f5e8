"""PyTorch port: the gauntlet (``twinvoice_tpu_torch.eval``) and the pieces
it stands on, against the JAX package: OpenCV's INTER_NEAREST
(``ops.host_image.resize_nearest_u8``), JAX's nearest device resize
(``ops.image.resize_nearest``), ``infer.postprocess.masks_and_boxes``, the
case resize and ground-truth boxes, ``run_segmenter_gauntlet`` per case on
rendered cases at a 64² grid (a random base-width-8 U-Net from one ``.pth``
in both packages), ``run_e2e_gauntlet`` with scripted OCR engines, and the
OCR engine protocol and fake."""

from dataclasses import replace

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.torch_oracle import random_state_dict
from twinvoice_tpu.config import FusionConfig as JaxFusionConfig
from twinvoice_tpu.config import InferConfig as JaxInferConfig
from twinvoice_tpu.config import UNetConfig as JaxUNetConfig
from twinvoice_tpu.data.augment import boxes_from_mask as jax_boxes_from_mask
from twinvoice_tpu.eval import gauntlet as jg
from twinvoice_tpu.fusion.extract import InvoiceExtractor as JaxExtractor
from twinvoice_tpu.infer.pipeline import Segmenter as JaxSegmenter
from twinvoice_tpu.infer.postprocess import masks_and_boxes as jax_masks_and_boxes
from twinvoice_tpu.ocr.fake import FakeOcrEngine as JaxFake
from twinvoice_tpu.ops.image import resize_nearest as jax_resize_nearest
from twinvoice_tpu_torch.config import FusionConfig, InferConfig, UNetConfig
from twinvoice_tpu_torch.eval import gauntlet as tg
from twinvoice_tpu_torch.fusion.extract import InvoiceExtractor
from twinvoice_tpu_torch.infer import Segmenter, masks_and_boxes
from twinvoice_tpu_torch.ocr import FakeOcrEngine, OcrEngine
from twinvoice_tpu_torch.ocr.base import NullOcrEngine
from twinvoice_tpu_torch.ocr.torchocr import TorchOcrEngine
from twinvoice_tpu_torch.ops.host_image import resize_nearest_u8
from twinvoice_tpu_torch.ops.image import resize_nearest

GRID = 64


@settings(max_examples=150, deadline=None, database=None)
@given(h=st.integers(1, 120), w=st.integers(1, 120), oh=st.integers(1, 300),
       ow=st.integers(1, 300), chans=st.sampled_from([0, 1, 3, 4]),
       seed=st.integers(0, 2 ** 16))
def test_resize_nearest_u8_equals_cv2_inter_nearest(h, w, oh, ow, chans, seed):
    shape = (h, w) + ((chans,) if chans else ())
    img = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_NEAREST)
    got = resize_nearest_u8(img, ow, oh)
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    assert got.shape[:2] == (oh, ow)


@pytest.mark.parametrize("src,dst", [((745, 395), (512, 512)), ((681, 465), (512, 512)),
                                     ((3, 7), (512, 384)), ((512, 512), (745, 395)),
                                     ((1001, 1), (17, 33))])
def test_resize_nearest_u8_at_case_sizes(src, dst):
    img = np.random.default_rng(src[0]).integers(0, 256, src + (3,), dtype=np.uint8)
    np.testing.assert_array_equal(resize_nearest_u8(img, dst[1], dst[0]), cv2.resize(
        img, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("m,n", [(7, 3), (3, 7), (10, 25), (25, 10), (100, 99), (99, 100),
                                 (64, 1000), (513, 511), (31, 33), (1, 5), (5, 1)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.bool_])
def test_device_resize_nearest_equals_jax(m, n, dtype):
    """``jax.image.resize(method="nearest")`` samples at half-pixel centres
    (with XLA's folded reciprocal), unlike ``F.interpolate``'s nearest; odd
    up- and down-scales, H and W apart."""
    x = np.random.default_rng(m * n).integers(0, 200, (2, m, m + 2, 3)).astype(dtype)
    want = np.asarray(jax_resize_nearest(x, n, n + 1))
    got = resize_nearest(torch.from_numpy(x).permute(0, 3, 1, 2), n, n + 1)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    np.testing.assert_array_equal(
        resize_nearest(torch.from_numpy(x[0]).permute(2, 0, 1), n, n + 1)
        .permute(1, 2, 0).numpy(), np.asarray(jax_resize_nearest(x[0], n, n + 1)))


@pytest.mark.parametrize("seed,grid,orig", [(0, 32, (640, 480)), (1, 64, (37, 90)),
                                            (2, 17, (17, 17)), (3, 48, (1000, 300))])
def test_masks_and_boxes_equals_jax(seed, grid, orig):
    rng = np.random.default_rng(seed)
    prob = rng.uniform(0, 1, (grid, grid, 3)).astype(np.float32) ** 6
    prob[..., 2] *= 0.2  # the third field stays below its threshold
    thr, pad = (0.25, 0.40, 0.30), 0.15
    size = np.asarray(orig, np.int32)
    jm, jb, jo = jax_masks_and_boxes(jnp.asarray(prob), jnp.asarray(size), thr, pad)
    tm, tb, to = masks_and_boxes(torch.from_numpy(prob), torch.from_numpy(size), thr, pad)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert tb.dtype == torch.int32 and to.numpy()[:2].any() and not to.numpy()[2]


def to_port(c):
    return tg.GauntletCase(c.image, c.mask, c.invoice_no, c.date, c.amount, c.level, c.font)


@pytest.fixture(scope="module")
def cases():
    """Two rendered invoices, clean and under two perturbations, and one
    whose date field left the frame."""
    base = jg.make_base_cases(2)
    out = base + jg.perturb_cases(base, "mild", seed=3) + jg.perturb_cases(
        base[:1], "crumple", seed=3)
    gone = out[0].mask.copy()
    gone[..., 1] = 0
    return out + [replace(out[0], mask=gone)]


def test_resize_case_and_boxes_from_mask_equal_jax(cases):
    for c in cases:
        for size in (GRID, 512, 383):
            ji, jm = jg._resize_case(c, size)
            ti, tm = tg._resize_case(to_port(c), size)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tm, jm)
        assert tg.boxes_from_mask(c.mask) == jax_boxes_from_mask(c.mask)
    assert 1 not in tg.boxes_from_mask(cases[-1].mask)


@pytest.fixture(scope="module")
def segmenters(tmp_path_factory):
    sd = random_state_dict(np.random.default_rng(5), widths=(8, 16, 32, 64), scale=0.3)
    path = str(tmp_path_factory.mktemp("g") / "model.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    jseg = JaxSegmenter.from_pth(path, JaxUNetConfig(base_width=8),
                                 JaxInferConfig(img_size=GRID), jnp.float32)
    tseg = Segmenter.from_pth(path, UNetConfig(base_width=8), InferConfig(img_size=GRID),
                              device="cpu")
    return jseg, tseg


def test_run_segmenter_gauntlet_equals_jax_per_case(segmenters, cases):
    jseg, tseg = segmenters
    for c in cases:
        want = jg.run_segmenter_gauntlet(jseg, [c])
        assert tg.run_segmenter_gauntlet(tseg, [to_port(c)]) == want
    want = jg.run_segmenter_gauntlet(jseg, cases)
    got = tg.run_segmenter_gauntlet(tseg, [to_port(c) for c in cases])
    assert got == want
    assert got["n"] == len(cases) and 0 < got["iou_mean"] < 1
    assert 0 < got["box_hit_mean"] < 1  # some boxes hit, some miss


def test_case_scores_field_gone_is_a_hit_only_when_not_found(cases):
    c = to_port(cases[-1])
    pred = np.zeros((2, GRID, GRID, 3), bool)
    gts = np.zeros_like(pred)
    boxes = np.zeros((2, 3, 4), np.int32)
    boxes[:, :, 2:] = 1000  # covers the page
    ok = np.asarray([[True, True, True], [True, False, True]])
    iou, hits = tg._case_scores([c, c], gts, pred, boxes, ok)
    np.testing.assert_array_equal(iou, 0.0)
    np.testing.assert_array_equal(hits, [[True, False, True], [True, True, True]])


def script(texts):
    """An OCR script: the text for each field's mode."""
    return lambda image, mode: texts.get(mode, "")


@pytest.mark.parametrize("texts", [
    {"invoice": "ON 0874-0800", "date": "2029/06/02", "amount": "NT$77,143"},
    {"invoice": "XX", "date": "2029-6-2", "amount": "4659"}])
def test_run_e2e_gauntlet_equals_jax(segmenters, cases, texts):
    jseg, tseg = segmenters
    cfg = dict(use_qr=False, auto_rotate=False)
    jex = JaxExtractor(jseg, None, engines=[JaxFake(script(texts))],
                       cfg=JaxFusionConfig(**cfg))
    fake = FakeOcrEngine(script(texts))
    tex = InvoiceExtractor(tseg, None, engines=[fake], cfg=FusionConfig(**cfg))
    want = jg.run_e2e_gauntlet(jex, cases)
    got = tg.run_e2e_gauntlet(tex, [to_port(c) for c in cases])
    assert got == want
    assert fake.calls  # the engine read crops
    assert sum(v for k, v in got.items() if k != "n") > 0


def test_fake_engine_and_protocol_equal_jax():
    for make in (lambda s: JaxFake(s), lambda s: FakeOcrEngine(s)):
        assert make("x").read(None).text == "x"
    jf, tf = JaxFake(["a", "b"]), FakeOcrEngine(["a", "b"])
    got = [(r.text, r.engine) for r in (tf.read(None, "amount"), tf.read(None), tf.read(None))]
    want = [(r.text, r.engine) for r in (jf.read(None, "amount"), jf.read(None), jf.read(None))]
    assert got == want == [("a", "fake"), ("b", "fake"), ("", "fake")]
    assert tf.calls == jf.calls == ["amount", "text", "text"]
    assert isinstance(tf, OcrEngine) and isinstance(NullOcrEngine(), OcrEngine)
    assert isinstance(TorchOcrEngine(device="cpu"), OcrEngine)
    assert not isinstance(object(), OcrEngine)
