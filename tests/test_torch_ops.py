"""PyTorch port: conv / pool / BN-fold / resize ops and the BN-folded U-Net
against the JAX package at float32, from the same numpy inputs.

Tolerances: float convolutions sum in another order in XLA and PyTorch, so
outputs agree to float32 rounding (atol 1e-4 on O(1) activations); the BN
fold and the max pool are elementwise and must be bit-equal.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from twinvoice_tpu.models.unet import fold_unet as jax_fold_unet
from twinvoice_tpu.models.unet import unet_apply_folded as jax_unet_apply_folded
from twinvoice_tpu.ops import conv as jconv
from twinvoice_tpu.ops.image import resize_bilinear as jax_resize
from twinvoice_tpu.ops.norm import fold_batchnorm_into_conv as jax_fold_bn
from twinvoice_tpu_torch.config import UNetConfig
from twinvoice_tpu_torch.models.unet import fold_unet, unet_apply_folded
from twinvoice_tpu_torch.ops import conv as tconv
from twinvoice_tpu_torch.ops.image import normalize_uint8, resize_bilinear
from twinvoice_tpu_torch.ops.norm import fold_batchnorm_into_conv
from twinvoice_tpu_torch.weights import from_jax_params

from tests.torch_port_cases import random_unet

ATOL = 1e-4


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _conv_params(rng, k, ci, co):
    kernel = (rng.standard_normal((k, k, ci, co)) / np.sqrt(k * k * ci)).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    jp = {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}
    tp = {"weight": torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))),
          "bias": torch.from_numpy(bias)}
    return jp, tp


@pytest.mark.parametrize("op,k", [("conv3x3", 3), ("conv1x1", 1)])
def test_conv_matches_jax(rng, op, k):
    x = rng.standard_normal((2, 12, 10, 5)).astype(np.float32)
    jp, tp = _conv_params(rng, k, 5, 7)
    want = np.asarray(getattr(jconv, op)(jnp.asarray(x), jp))
    got = nhwc(getattr(tconv, op)(nchw(x), tp))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_conv_transpose2x2_matches_jax(rng):
    x = rng.standard_normal((2, 6, 5, 8)).astype(np.float32)
    kernel = rng.standard_normal((2, 2, 8, 4)).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    want = np.asarray(jconv.conv_transpose2x2_serving(
        jnp.asarray(x), {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}))
    tp = {"weight": torch.from_numpy(np.ascontiguousarray(kernel.transpose(2, 3, 0, 1))),
          "bias": torch.from_numpy(bias)}
    got = nhwc(tconv.conv_transpose2x2(nchw(x), tp))
    assert got.shape == (2, 12, 10, 4)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_max_pool2_matches_jax(rng):
    x = rng.standard_normal((2, 9, 8, 3)).astype(np.float32)  # odd H: floor mode
    want = np.asarray(jconv.max_pool2(jnp.asarray(x)))
    np.testing.assert_array_equal(nhwc(tconv.max_pool2(nchw(x))), want)


def test_fold_batchnorm_bit_equal(rng):
    jp, tp = _conv_params(rng, 3, 4, 6)
    scale, shift, mean = (rng.standard_normal(6).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.1, 2.0, 6).astype(np.float32)
    jf = jax_fold_bn(jp, {"scale": jnp.asarray(scale), "bias": jnp.asarray(shift)},
                     {"mean": jnp.asarray(mean), "var": jnp.asarray(var)})
    tf = fold_batchnorm_into_conv(
        tp, {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(shift)},
        {"mean": torch.from_numpy(mean), "var": torch.from_numpy(var)})
    np.testing.assert_array_equal(tf["weight"].numpy(),
                                  np.asarray(jf["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tf["bias"].numpy(), np.asarray(jf["bias"]))


@pytest.mark.parametrize("src", [(640, 440), (1080, 1920), (40, 48), (96, 30)],
                         ids=["mixed-down-H-up-W", "down", "up", "mixed-up-H-down-W"])
def test_resize_bilinear_matches_jax(rng, src):
    """Downscale antialiases in both; 640×440→64² and 96×30 mix the two."""
    h, w = src
    size = 64 if h < 1000 else 512
    x = rng.integers(0, 256, (2, h, w, 3)).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), size, size))
    got = nhwc(resize_bilinear(nchw(x), size, size))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_normalize_uint8_matches_jax(rng):
    from twinvoice_tpu.ops.image import normalize_uint8 as jax_normalize

    x = rng.integers(0, 256, (1, 4, 5, 3), dtype=np.uint8)
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jax_normalize(jnp.asarray(x), jd).astype(jnp.float32))
        got = nhwc(normalize_uint8(nchw(x), td).to(torch.float32))
        np.testing.assert_array_equal(got, want)


def test_unet_apply_folded_matches_jax(rng):
    jcfg, params, state = random_unet(1)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jfolded = jax_fold_unet(jax.tree.map(jnp.asarray, params),
                            jax.tree.map(jnp.asarray, state), cfg=jcfg)
    want = np.asarray(jax_unet_apply_folded(jfolded, jnp.asarray(x)))
    tp, ts = from_jax_params(params, state)
    folded = fold_unet(tp, ts, cfg=UNetConfig(base_width=8))
    # the folded weights themselves are bit-equal (elementwise fold)
    np.testing.assert_array_equal(
        folded["dec"][1]["conv1"]["weight"].numpy(),
        np.asarray(jfolded["dec"][1]["conv1"]["kernel"]).transpose(3, 2, 0, 1))
    with torch.inference_mode():
        got = nhwc(unet_apply_folded(folded, nchw(x)))
    assert got.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
