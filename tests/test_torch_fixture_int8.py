"""PyTorch port on the bundled w16 segmenter, int8: the fixture that
``chip_smoke.py`` holds the card's int8 routes against
(``tests/data/torch_smoke_int8.npz``) is reproduced from its script, the
port's calibration scales are within 1e-5 of JAX's on it, and with JAX's
scales carried in, the port's CPU int8 routes equal it exactly."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from twinvoice_tpu_torch.infer import quant
from twinvoice_tpu_torch.infer.postprocess import bbox_from_probs
from twinvoice_tpu_torch.models.pretrained import load_pretrained_segmenter, variant_path
from twinvoice_tpu_torch.models.unet import fold_unet
from twinvoice_tpu_torch.weights import load_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_smoke_int8.npz")


def _script():
    path = os.path.join(ROOT, "scripts", "make_torch_smoke_int8.py")
    spec = importlib.util.spec_from_file_location("make_torch_smoke_int8", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fix():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


def test_int8_fixture_reproduces_from_its_script(fix):
    assert os.path.getsize(FIXTURE) < 500_000
    mod = _script()
    ref = mod.jax_reference(mod.load_pages())
    assert set(ref) == set(fix)
    for k, v in ref.items():
        np.testing.assert_array_equal(v, fix[k], err_msg=k)
    assert all(fix[f"{r}_ok"].all() for r in mod.ROUTES)  # every field found


def test_port_calibration_within_1e5_of_jax(fix):
    params, state = load_npz(variant_path("w16"))
    folded = fold_unet(params, state, dtype=torch.float32, device="cpu")
    rgb = np.repeat(fix["calib"][..., None], 3, axis=-1)
    mine = quant.scales_to_array(quant.calibrate(folded, [rgb]))
    np.testing.assert_allclose(mine, fix["scales"], rtol=1e-5, atol=0)


@pytest.fixture(scope="module")
def segmenters(fix):
    scales = quant.scales_from_array(fix["scales"])
    return {route: load_pretrained_segmenter(torch.float32, variant="w16", device="cpu",
                                             int8_scales=scales, **kw)
            for route, kw in (("pallas", {"int8_head": "pallas"}),
                              ("pallas trunk", {"int8_pallas": True}))}


@pytest.mark.parametrize("route", ["xla", "raw", "pallas", "pallas trunk"])
def test_port_int8_routes_equal_jax_on_fixture(fix, segmenters, route):
    """``xla``: the masks path; ``raw``: device resize; ``pallas``: the fused
    head, box-only; ``pallas trunk``: the Pallas-form trunk, box-only, held
    to the fused head's JAX outputs (its trunk is bit-equal and its head the
    same float32 function)."""
    raw = np.repeat(_script().load_pages()[..., None], 3, axis=-1)
    rgb = np.repeat(fix["calib"][..., None], 3, axis=-1)
    h, w = raw.shape[1:3]
    sizes = np.tile(np.asarray([[w, h]], np.int32), (len(raw), 1))
    seg = segmenters["pallas trunk" if route == "pallas trunk" else "pallas"]
    if route == "raw":
        mask, boxes, ok = seg.segment_batch(raw, pre_resized=False)
    else:
        mask, boxes, ok = seg.segment_batch(rgb, sizes, return_masks=route == "xla")
    jr = "pallas" if route == "pallas trunk" else route
    np.testing.assert_array_equal(boxes.numpy(), fix[f"{jr}_boxes"])
    np.testing.assert_array_equal(ok.numpy(), fix[f"{jr}_ok"])
    if mask is not None:
        gboxes, gvalid = bbox_from_probs(mask.to(torch.float32), [0.5, 0.5, 0.5])
        np.testing.assert_array_equal(gboxes.numpy(), fix[f"{jr}_grid_boxes"])
        np.testing.assert_array_equal(gvalid.numpy(), fix[f"{jr}_grid_valid"])
