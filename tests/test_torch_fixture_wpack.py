"""PyTorch port on the bundled w16 segmenter, W-phase int8 routes: the CPU
"nhwc" box-only route on the first fixture page equals JAX's outputs stored in
``tests/data/torch_smoke_wpack.npz`` (made by
``scripts/make_torch_smoke_wpack.py``), and JAX's trunk sums stored there,
which ``chip_smoke.py`` holds the card to, are what the port computes on all
four pages. No JAX runs here: JAX's scales are
carried in from ``tests/data/torch_smoke_int8.npz``."""

import os
import warnings

import numpy as np
import pytest
import torch

from twinvoice_tpu_torch.infer import quant, wpack
from twinvoice_tpu_torch.models.pretrained import load_pretrained_segmenter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_smoke_wpack.npz")
INT8_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_smoke_int8.npz")
MODES = ("full", "enc", "nhwc")


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def fix():
    return _load(FIXTURE)


@pytest.fixture(scope="module")
def data():
    """(the 512² pages as (4,512,512,3) uint8, orig_sizes (4,2), the
    "nhwc" segmenter with JAX's scales)."""
    fix8 = _load(INT8_FIXTURE)
    rgb = np.repeat(fix8["calib"][..., None], 3, axis=-1)
    sizes = np.tile(np.asarray([[440, 640]], np.int32), (len(rgb), 1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the "nhwc" fallback note
        seg = load_pretrained_segmenter(
            torch.float32, variant="w16", device="cpu", int8_wpack="nhwc",
            int8_scales=quant.scales_from_array(fix8["scales"]))
    return rgb, sizes, seg


def _fingerprint(hp):
    return wpack.unpack(hp).to(torch.int64).sum(dim=(1, 2)).numpy()


def test_wpack_fixture_is_small_and_complete(fix):
    assert os.path.getsize(FIXTURE) < 1_000_000
    for m in MODES:
        assert fix[f"{m}_boxes"].shape == (4, 3, 4) and fix[f"{m}_ok"].all()
        assert fix[f"{m}_row_max"].shape == fix[f"{m}_col_max"].shape == (4, 512, 3)
        assert fix[f"{m}_fingerprint"].shape == (4, 16)
    assert fix["nhwc_masks_ok"].all()


def test_port_nhwc_route_equals_jax_on_the_first_page(fix, data):
    """Boxes and ok flags equal, bias-free maxima within 1e-5 (the bound of
    tests/unit/test_wpack.py: the K2 head's float32 sum runs in another order
    than XLA's), trunk sums equal: the K7b trunk's int8 features are JAX's on
    this page."""
    rgb, sizes, seg = data
    page = torch.from_numpy(rgb[:1])
    mask, boxes, ok = seg.segment_batch(page, sizes[:1], return_masks=False)
    assert mask is None
    np.testing.assert_array_equal(boxes.numpy(), fix["nhwc_boxes"][:1])
    np.testing.assert_array_equal(ok.numpy(), fix["nhwc_ok"][:1])
    with torch.inference_mode():
        row, col = wpack.unet_apply_quantized_nhwc_rowcol_max(seg.qparams, page)
        hp, _ = wpack.unet_apply_quantized_features_nhwc(seg.qparams, page)
    np.testing.assert_allclose(row.numpy(), fix["nhwc_row_max"][:1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(col.numpy(), fix["nhwc_col_max"][:1], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_fingerprint(hp), fix["nhwc_fingerprint"][:1])


@pytest.mark.parametrize("mode", ["full", "nhwc"])
def test_stored_port_sums_are_the_ports(fix, data, mode):
    """The sums that ``chip_smoke.py`` holds the card's trunks to exactly
    (JAX's) are the port's own, page by page: the port's epilogues fuse a
    multiply and an add where XLA does, so no requant tie splits them."""
    rgb, _, seg = data
    fn = (wpack.unet_apply_quantized_features_nhwc if mode == "nhwc"
          else wpack.unet_apply_quantized_features_wpack)
    with torch.inference_mode():
        got = np.concatenate([_fingerprint(fn(seg.qparams, torch.from_numpy(p))[0])
                              for p in np.split(rgb, len(rgb))])
    np.testing.assert_array_equal(got, fix[f"{mode}_fingerprint"])
