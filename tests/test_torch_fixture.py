"""PyTorch port on the bundled w16 segmenter: the fixture that
``chip_smoke.py`` holds the card against (``tests/data/torch_smoke_pages.npz``)
is reproduced from its script, and the port's float32 path equals it exactly
on the CPU. This file runs the one full-size JAX compile of the port's tests."""

import importlib.util
import os

import numpy as np
import torch

from twinvoice_tpu_torch.infer.pipeline import crop_fields
from twinvoice_tpu_torch.infer.postprocess import bbox_from_probs
from twinvoice_tpu_torch.models.pretrained import load_pretrained_segmenter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_smoke_pages.npz")


def _script():
    path = os.path.join(ROOT, "scripts", "make_torch_smoke_pages.py")
    spec = importlib.util.spec_from_file_location("make_torch_smoke_pages", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fixture():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


def test_fixture_reproduces_from_its_script():
    assert os.path.getsize(FIXTURE) < 500_000
    fix = _fixture()
    mod = _script()
    pages = mod.render_pages()
    np.testing.assert_array_equal(pages, fix["pages"])
    ref = mod.jax_reference(pages)
    assert set(ref) | {"pages"} == set(fix)
    for k, v in ref.items():
        np.testing.assert_array_equal(v, fix[k], err_msg=k)
    assert fix["ok"].all()  # the bundled model finds every field on these pages


def test_port_fp32_equals_jax_on_fixture_pages():
    fix = _fixture()
    seg = load_pretrained_segmenter(variant="w16", dtype=torch.float32, device="cpu")
    rgb = np.repeat(fix["pages"][..., None], 3, axis=-1)
    mask, boxes, ok = seg.segment_batch(rgb, pre_resized=False)
    np.testing.assert_array_equal(boxes.numpy(), fix["boxes"])
    np.testing.assert_array_equal(ok.numpy(), fix["ok"])
    gboxes, gvalid = bbox_from_probs(mask.to(torch.float32), [0.5, 0.5, 0.5])
    np.testing.assert_array_equal(gboxes.numpy(), fix["grid_boxes"])
    np.testing.assert_array_equal(gvalid.numpy(), fix["grid_valid"])
    for page, b, o in zip(fix["pages"], boxes.numpy(), ok.numpy()):
        crops = crop_fields(page, b, o, seg.cfg.black_crop_mean)
        assert all(c is not None and c.size > 0 for c in crops.values())
