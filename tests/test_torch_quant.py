"""PyTorch port: int8 calibration, quantization and the int8 forwards against
``twinvoice_tpu.infer.quant``, and the int8 ``Segmenter`` routes against the
JAX ``Segmenter``, on a small random U-Net (base width 8) from numpy.

The JAX functions run under ``jit`` with the qparams as arguments, as the
JAX ``Segmenter`` runs them (the activation scales are float32 there). With
JAX's qparams carried across, the int8 trunk is bit-equal; the float32
logits differ only in the order of the 1×1 conv's sum."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from twinvoice_tpu.config import InferConfig as JaxInferConfig
from twinvoice_tpu.infer import quant as jquant
from twinvoice_tpu.infer.pipeline import Segmenter as JaxSegmenter
from twinvoice_tpu.models.unet import fold_unet as jax_fold_unet
from twinvoice_tpu_torch.config import InferConfig, UNetConfig
from twinvoice_tpu_torch.infer import quant
from twinvoice_tpu_torch.infer.pipeline import Segmenter
from twinvoice_tpu_torch.models.unet import fold_unet
from twinvoice_tpu_torch.weights import from_jax_params, from_jax_qparams

from tests.test_torch_pipeline import pages
from tests.torch_port_cases import random_unet

GRID = 32


@pytest.fixture(scope="module")
def model():
    jcfg, params, state = random_unet(3)
    jfolded = jax_fold_unet(jax.tree.map(jnp.asarray, params),
                            jax.tree.map(jnp.asarray, state), cfg=jcfg)
    tp, ts = from_jax_params(params, state)
    folded = fold_unet(tp, ts, cfg=UNetConfig(base_width=8), dtype=torch.float32,
                       device="cpu")
    calib = [pages(5, 2, GRID, GRID), pages(6, 1, GRID, GRID)]
    jscales = jquant.calibrate(jfolded, calib)
    jq = jquant.quantize_unet(jfolded, calib)
    return {"jcfg": jcfg, "params": params, "state": state, "tp": tp, "ts": ts,
            "jfolded": jfolded, "folded": folded, "calib": calib,
            "jscales": jscales, "jq": jq, "q": from_jax_qparams(jq)}


def _imgs(seed=0, n=2):
    return pages(seed, n, GRID, GRID)


def test_calibration_scales_within_1e5_of_jax(model):
    mine = quant.scales_to_array(quant.calibrate(model["folded"], model["calib"]))
    ref = quant.scales_to_array(model["jscales"])
    assert mine.shape == (5 * 4 + 2,)
    np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=0)
    assert quant.scales_to_array(quant.scales_from_array(ref)).tolist() == ref.tolist()


def test_quantize_unet_equals_jax(model):
    """Same folded float32 tree and scales: int8 kernels, w_scale, biases and
    the harmonised scales are exactly JAX's."""
    q = quant.quantize_unet(model["folded"], scales=model["jscales"])

    def same(a, b, path=""):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}[{i}]")
        elif isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), path
        else:
            assert a == b, (path, a, b)

    same(q, model["q"])
    for j, uq in enumerate(q["up"]):  # harmonised: one input scale per decoder conv1
        assert uq["s_out"] == q["enc"][len(q["enc"]) - 1 - j]["s2"]
    assert q["enc"][0]["conv1"]["kernel"].shape == (8, 3, 3, 3)
    assert q["up"][0]["kernel"].shape == (64, 2, 2, 128)  # bottleneck → level 3


@pytest.mark.parametrize("concat", [True, False])
def test_int8_trunk_bit_equal_to_jax(model, concat):
    imgs = _imgs()
    jh, js = jax.jit(jquant.unet_apply_quantized_features,
                     static_argnames="concat")(model["jq"], jnp.asarray(imgs),
                                               concat=concat)
    th, ts = quant.unet_apply_quantized_features(model["q"], torch.from_numpy(imgs),
                                                 concat=concat)
    assert th.dtype == torch.int8 and th.is_contiguous()
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert np.float32(ts) == np.asarray(js)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_jax(model, dtype):
    """float32 logits within 1e-5; bf16 logits within one bf16 step."""
    imgs = _imgs(1)
    jl = jax.jit(jquant.unet_apply_quantized, static_argnames="logits_dtype")(
        model["jq"], jnp.asarray(imgs), logits_dtype=getattr(jnp, dtype))
    tl = quant.unet_apply_quantized(model["q"], torch.from_numpy(imgs),
                                    logits_dtype=getattr(torch, dtype))
    assert tl.dtype == getattr(torch, dtype) and tl.shape == (2, GRID, GRID, 3)
    ref = np.asarray(jl.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(tl.numpy(), ref, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(tl.float().numpy(), ref, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("trunk", ["xla+head", "pallas"])
def test_rowcol_maxima_match_jax(model, trunk):
    """The fused head on the concat trunk (K2) and the Pallas-form trunk with
    its plain head, against JAX's, at JAX's tolerance
    (tests/unit/test_qconv_pallas.py: rtol 2e-2, atol 5e-2)."""
    imgs = _imgs(2)
    if trunk == "pallas":
        jpq = jquant.prepack_pallas(model["jq"], img_size=GRID, batch=2)
        jr, jc = jax.jit(jquant.unet_apply_quantized_pallas_rowcol_max)(
            model["jq"], jpq, jnp.asarray(imgs))
        tr, tc = quant.unet_apply_quantized_pallas_rowcol_max(
            model["q"], quant.prepack_pallas(model["q"]), torch.from_numpy(imgs))
    else:
        jr, jc = jax.jit(jquant.unet_apply_quantized_rowcol_max)(
            model["jq"], jnp.asarray(imgs))
        tr, tc = quant.unet_apply_quantized_rowcol_max(model["q"], torch.from_numpy(imgs))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=2e-2, atol=5e-2)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=2e-2, atol=5e-2)


ROUTES = {
    "xla": {},
    "xla-bf16": {"int8_head": "xla-bf16"},
    "pallas": {"int8_head": "pallas"},
    "pallas trunk": {"int8_pallas": True},
}


@pytest.fixture(scope="module")
def segmenters(model):
    out = {}
    for route, kw in ROUTES.items():
        jseg = JaxSegmenter(model["params"], model["state"], model["jcfg"],
                            JaxInferConfig(img_size=GRID), dtype=jnp.float32,
                            int8_calib=model["calib"], **kw)
        tseg = Segmenter(model["tp"], model["ts"], UNetConfig(base_width=8),
                         InferConfig(img_size=GRID), dtype=torch.float32,
                         device="cpu", int8_calib=model["calib"], **kw)
        out[route] = (jseg, tseg)
    return out


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("return_masks", [True, False])
def test_segmenter_int8_routes_match_jax(segmenters, route, return_masks):
    """ok flags equal; boxes exactly equal on the xla routes and within JAX's
    own 12-px rule on the head routes (tests/unit/test_quant.py:100-102); the
    masks path of every route is the xla route."""
    jseg, tseg = segmenters[route]
    x = pages(0, 4, GRID, GRID)
    sizes = np.asarray([[640, 480], [GRID, GRID], [1000, 300], [37, 90]], np.int32)
    jm, jb, jo = jseg.segment_batch(x, sizes, return_masks=return_masks)
    tm, tb, to = tseg.segment_batch(x, sizes, return_masks=return_masks)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    ok = to.numpy()
    assert ok.any() and not ok.all(), ok  # both outcomes are exercised
    head_route = not return_masks and route in ("pallas", "pallas trunk")
    if head_route:
        d = np.abs(tb.numpy().astype(np.int64) - np.asarray(jb, np.int64))[ok]
        assert d.max() <= 12, d.max()
    else:
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    if return_masks:
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    else:
        assert tm is None


def test_segmenter_int8_device_resize_and_gray_match_jax(segmenters):
    """pre_resized=False resizes, rounds to uint8 and runs the xla route; the
    luminance upload replicates the gray page on the device first."""
    jseg, tseg = segmenters["pallas"]
    raw = pages(1, 3, 100, 48)
    jm, jb, jo = jseg.segment_batch(raw, pre_resized=False)
    tm, tb, to = tseg.segment_batch(raw, pre_resized=False)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    gray = pages(2, 2, GRID, GRID)[..., 0]
    sizes = np.asarray([[GRID, GRID]] * 2, np.int32)
    jm, jb, jo = jseg._run_gray(jseg._serve_params, jnp.asarray(gray), jnp.asarray(sizes))
    tm, tb, to = tseg._run(gray, sizes)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
