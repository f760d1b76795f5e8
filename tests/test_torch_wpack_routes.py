"""PyTorch port: the ``Segmenter(int8_wpack=...)`` routes against the JAX
``Segmenter`` on a random base-width-8 U-Net at a 32² grid, both calibrated
on the same batches (as ``tests/test_torch_quant.py`` holds the other int8
routes).

The W-phase box-only routes compute float32 maxima of a bit-equal int8 trunk
in both packages, so boxes, ok flags and masks must be equal; the routes'
precedence, fallbacks and warning must be JAX's
(``twinvoice_tpu/infer/pipeline.py:107-234``)."""

import warnings

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from twinvoice_tpu.config import InferConfig as JaxInferConfig
from twinvoice_tpu.infer.pipeline import Segmenter as JaxSegmenter
from twinvoice_tpu_torch.config import InferConfig, UNetConfig
from twinvoice_tpu_torch.infer.pipeline import Segmenter

from tests.test_torch_pipeline import pages
from tests.torch_port_cases import int8_unet

GRID = 32
WPACK = {"True": True, "full": "full", "enc": "enc", "nhwc": "nhwc"}
SIZES = np.asarray([[640, 480], [GRID, GRID], [1000, 300], [37, 90]], np.int32)


@pytest.fixture(scope="module")
def model():
    return int8_unet(3, GRID)


def _pair(model, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the "nhwc" fallback note
        jseg = JaxSegmenter(model["params"], model["state"], model["jcfg"],
                            JaxInferConfig(img_size=GRID), dtype=jnp.float32,
                            int8_calib=model["calib"], **kw)
        tseg = _port(model, **kw)
    return jseg, tseg


def _port(model, **kw):
    return Segmenter(model["tp"], model["ts"], UNetConfig(base_width=8),
                     InferConfig(img_size=GRID), dtype=torch.float32, device="cpu",
                     int8_calib=model["calib"], **kw)


@pytest.fixture(scope="module")
def segmenters(model):
    return {name: _pair(model, int8_wpack=v) for name, v in WPACK.items()}


def _assert_equal(jout, tout, masks):
    jm, jb, jo = jout
    tm, tb, to = tout
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    if masks:
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    else:
        assert tm is None and jm is None


@pytest.mark.parametrize("route", list(WPACK))
@pytest.mark.parametrize("return_masks", [True, False])
def test_segmenter_wpack_routes_match_jax(segmenters, route, return_masks):
    """Box-only: the W-phase trunk and its float32 row/col head ("nhwc": the
    K7b trunk); with masks: the W-phase logits ("nhwc" falls back to
    "full")."""
    jseg, tseg = segmenters[route]
    x = pages(0, 4, GRID, GRID)
    jout = jseg.segment_batch(x, SIZES, return_masks=return_masks)
    tout = tseg.segment_batch(x, SIZES, return_masks=return_masks)
    _assert_equal(jout, tout, return_masks)
    ok = tout[2].numpy()
    assert ok.any() and not ok.all(), ok  # both outcomes are exercised


@pytest.mark.parametrize("route", ["enc", "nhwc"])
def test_segmenter_wpack_device_resize_matches_jax(segmenters, route):
    """pre_resized=False: resize, round to uint8, the W-phase logits ("nhwc"
    falls back to "full"), masks always returned."""
    jseg, tseg = segmenters[route]
    raw = pages(1, 3, 100, 48)
    jout = jseg.segment_batch(raw, pre_resized=False)
    tout = tseg.segment_batch(raw, pre_resized=False, return_masks=False)
    _assert_equal(jout, tout, masks=True)


def test_nhwc_warns_at_construction_quantized_or_not(model):
    for kw in ({"int8_calib": model["calib"]}, {}):
        with pytest.warns(UserWarning, match="int8_wpack='nhwc' applies only"):
            Segmenter(model["tp"], model["ts"], UNetConfig(base_width=8),
                      InferConfig(img_size=GRID), device="cpu", int8_wpack="nhwc", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no other value warns
        for v in (True, "full", "enc"):
            _port(model, int8_wpack=v)


def test_wpack_is_ignored_without_int8(model):
    """Without int8 the float forward serves whatever ``int8_wpack`` says."""
    x = pages(0, 2, GRID, GRID)
    plain = Segmenter(model["tp"], model["ts"], UNetConfig(base_width=8),
                      InferConfig(img_size=GRID), dtype=torch.float32, device="cpu")
    wp = Segmenter(model["tp"], model["ts"], UNetConfig(base_width=8),
                   InferConfig(img_size=GRID), dtype=torch.float32, device="cpu",
                   int8_wpack="full")
    assert wp.wpack_mode is None
    for a, b in zip(plain.segment_batch(x), wp.segment_batch(x)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("head", ["pallas head", "pallas trunk", "xla-bf16"])
def test_route_precedence_over_wpack(model, segmenters, head):
    """Box-only: ``int8_head="pallas"`` and ``int8_pallas=True`` take
    precedence over ``int8_wpack`` (the port's outputs equal the same route
    without it, and JAX's within JAX's own 12-px rule for the head routes,
    as test_torch_quant.py); ``"xla-bf16"`` does not change a W-phase route."""
    kw = {"pallas head": {"int8_head": "pallas"}, "pallas trunk": {"int8_pallas": True},
          "xla-bf16": {"int8_head": "xla-bf16"}}[head]
    x = pages(0, 4, GRID, GRID)
    jseg, tseg = _pair(model, int8_wpack="nhwc", **kw)
    without = segmenters["nhwc"][1] if head == "xla-bf16" else _port(model, **kw)
    _, tb, to = tseg.segment_batch(x, SIZES, return_masks=False)
    _, wb, wo = without.segment_batch(x, SIZES, return_masks=False)
    assert torch.equal(tb, wb) and torch.equal(to, wo)
    _, jb, jo = jseg.segment_batch(x, SIZES, return_masks=False)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    d = np.abs(tb.numpy().astype(np.int64) - np.asarray(jb, np.int64))[to.numpy()]
    assert d.max() <= (12 if head != "xla-bf16" else 0), d.max()
