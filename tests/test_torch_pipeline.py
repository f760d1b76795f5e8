"""PyTorch port: the ``Segmenter`` serving path against the JAX ``Segmenter``
at float32 on a small random U-Net (base width 8, 64² grid). Boxes and ok
flags must be equal; masks too, for the same reason (the logits agree to
float32 rounding and no pixel sits on a threshold)."""

import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from PIL import Image

from twinvoice_tpu.config import InferConfig as JaxInferConfig
from twinvoice_tpu.infer.pipeline import Segmenter as JaxSegmenter
from twinvoice_tpu_torch import FIELDS
from twinvoice_tpu_torch.config import InferConfig, UNetConfig
from twinvoice_tpu_torch.infer.pipeline import Segmenter, crop_fields
from twinvoice_tpu_torch.models.pretrained import load_pretrained_segmenter
from twinvoice_tpu_torch.weights import from_jax_params

from tests.torch_port_cases import random_unet

GRID = 64


@pytest.fixture(scope="module")
def pair():
    jcfg, params, state = random_unet(3)
    jseg = JaxSegmenter(params, state, jcfg, JaxInferConfig(img_size=GRID),
                        dtype=jnp.float32)
    tp, ts = from_jax_params(params, state)
    tseg = Segmenter(tp, ts, UNetConfig(base_width=8), InferConfig(img_size=GRID),
                     dtype=torch.float32, device="cpu")
    return jseg, tseg


def pages(seed, n, h, w):
    """Bright pages with dark rectangles of 'text' (the crops are not black)."""
    rng = np.random.default_rng(seed)
    out = np.full((n, h, w, 3), 235, np.uint8)
    out += rng.integers(0, 20, out.shape, dtype=np.uint8)
    for i in range(n):
        for _ in range(6):
            y, x = rng.integers(0, h - 8), rng.integers(0, w - 16)
            out[i, y:y + rng.integers(3, 8), x:x + rng.integers(8, 16)] = rng.integers(0, 60)
    return out


def assert_same(jout, tout, masks=True):
    jm, jb, jo = jout
    tm, tb, to = tout
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    if masks:
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("return_masks", [True, False])
def test_segment_batch_pre_resized(pair, return_masks):
    jseg, tseg = pair
    x = pages(0, 4, GRID, GRID)
    sizes = np.asarray([[640, 480], [GRID, GRID], [1000, 300], [37, 90]], np.int32)
    jout = jseg.segment_batch(x, sizes, return_masks=return_masks)
    tout = tseg.segment_batch(x, sizes, return_masks=return_masks)
    assert (tout[0] is None) == (not return_masks)
    assert_same(jout, tout, masks=return_masks)
    ok = tout[2].numpy()
    assert ok.any() and not ok.all(), ok  # the case exercises both outcomes


@pytest.mark.parametrize("return_masks", [True, False])
def test_segment_batch_raw_device_resize(pair, return_masks):
    """pre_resized=False: the device resize shrinks H and grows W at once,
    and returns the masks whatever ``return_masks`` says, as JAX's does."""
    jseg, tseg = pair
    x = pages(1, 3, 100, 48)
    jout = jseg.segment_batch(x, pre_resized=False, return_masks=return_masks)
    tout = tseg.segment_batch(x, pre_resized=False, return_masks=return_masks)
    assert tout[1].shape == (3, 3, 4) and tout[2].dtype == torch.bool
    assert tout[0] is not None and tout[0].shape == (3, GRID, GRID, 3)
    assert_same(jout, tout, masks=True)


def _pil_pages(seed, n):
    sizes = [(90, 120), (64, 64), (150, 70), (40, 200)]
    return [Image.fromarray(pages(seed + i, 1, h, w)[0]) for i, (w, h) in
            zip(range(n), sizes)]


def _assert_crops_equal(jcrops, tcrops):
    assert set(jcrops) == set(tcrops) == set(FIELDS)
    for f in FIELDS:
        assert (jcrops[f] is None) == (tcrops[f] is None), f
        if jcrops[f] is not None:
            assert jcrops[f].size == tcrops[f].size
            np.testing.assert_array_equal(np.asarray(tcrops[f]), np.asarray(jcrops[f]))


def test_segment_pil(pair):
    jseg, tseg = pair
    for img in _pil_pages(10, 3):
        jmasks, jcrops = jseg.segment_pil(img)
        tmasks, tcrops = tseg.segment_pil(img)
        for f in FIELDS:
            np.testing.assert_array_equal(tmasks[f], np.asarray(jmasks[f]))
        _assert_crops_equal(jcrops, tcrops)


@pytest.mark.parametrize("gray_h2d,return_masks,cv2", [
    (False, True, True), (True, False, True), (True, False, False)])
def test_segment_pil_batch(pair, monkeypatch, gray_h2d, return_masks, cv2):
    """Both packages resize on the host with OpenCV, or Pillow without it."""
    if not cv2:
        monkeypatch.setitem(sys.modules, "cv2", None)
    jseg, tseg = pair
    imgs = _pil_pages(20, 4)
    kw = dict(gray_h2d=gray_h2d, return_masks=return_masks)
    jout = jseg.segment_pil_batch(imgs, **kw)
    tout = tseg.segment_pil_batch(imgs, **kw)
    assert len(jout) == len(tout) == len(imgs)
    for (jm, jc), (tm, tc) in zip(jout, tout):
        assert (tm is None) == (not return_masks)
        if return_masks:
            for f in FIELDS:
                np.testing.assert_array_equal(tm[f], np.asarray(jm[f]))
        _assert_crops_equal(jc, tc)


def test_crop_fields_rule():
    page = np.full((50, 60), 200, np.uint8)
    page[10:20, 30:40] = 0  # an all-black field
    boxes = np.asarray([[5, 5, 25, 15], [30, 10, 40, 20], [0, 0, 60, 50]])
    crops = crop_fields(page, boxes, np.asarray([True, True, False]), 3.0)
    assert crops["invoice_no"].shape == (10, 20)
    assert crops["date"] is None  # mean 0 < 3: rejected as all-black
    assert crops["total_amount"] is None  # not found


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch, pair):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tseg = pair
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_pretrained_segmenter()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Segmenter({}, {}, device=None)
    assert tseg.device.type == "cpu"


def test_load_pretrained_segmenter_takes_jax_positional_order():
    """``(dtype, infer_cfg, variant)`` means the same in both packages, and
    ``available`` agrees on every variant."""
    from twinvoice_tpu.models import pretrained as jpretrained
    from twinvoice_tpu_torch.models import pretrained

    jseg = jpretrained.load_pretrained_segmenter(jnp.float32, JaxInferConfig(img_size=64),
                                                 "w16_g384")
    tseg = load_pretrained_segmenter(torch.float32, InferConfig(img_size=64), "w16_g384",
                                     device="cpu")
    assert jseg.dtype == jnp.float32 and tseg.dtype == torch.float32
    assert jseg.cfg.img_size == tseg.cfg.img_size == 64
    assert jseg.model_cfg.base_width == tseg.model_cfg.base_width == 16
    # the variant's own weights: the folded out conv of w16_g384, not of w16
    w = np.asarray(jseg.folded["out"]["kernel"])[0, 0]
    np.testing.assert_array_equal(tseg.folded["out"]["weight"][:, :, 0, 0].numpy().T, w)
    w16 = load_pretrained_segmenter(torch.float32, None, "w16", device="cpu")
    assert not torch.equal(w16.folded["out"]["weight"], tseg.folded["out"]["weight"])
    for v in pretrained.VARIANTS:
        assert pretrained.available(v) == jpretrained.available(v)
    assert pretrained.available("w16")
