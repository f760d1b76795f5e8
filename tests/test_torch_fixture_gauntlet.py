"""PyTorch port: the gauntlet's card fixture
(``tests/data/torch_smoke_gauntlet.npz``). Its cases round-trip through
``eval.save_cases``/``load_cases`` and re-render from its script, whose JAX
w16 fp32 results reproduce; and ``chip_smoke.py``'s phase-26 checks pass on
the CPU against the JAX results stored there: the bundled w16 at fp32 and
on the int8 concat trunk give JAX's per-case masks, IoU, hits, boxes and ok
flags exactly, the bf16 w16 and w64 stay within ``GAUNTLET_IOU_TOL``, and
the e2e run's fields equal JAX's."""

import importlib.util
import json
import os

import numpy as np
import pytest

import chip_smoke
from twinvoice_tpu_torch.eval import GauntletCase, load_cases, save_cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = chip_smoke.GAUNTLET_FIXTURE


def _script():
    path = os.path.join(ROOT, "scripts", "make_torch_smoke_gauntlet.py")
    spec = importlib.util.spec_from_file_location("make_torch_smoke_gauntlet", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fix():
    return chip_smoke.gauntlet_fixture()


def assert_cases_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.image, w.image)
        np.testing.assert_array_equal(g.mask, w.mask)
        assert g.image.dtype == g.mask.dtype == np.uint8
        assert (g.invoice_no, g.date, g.amount, g.level, g.font) == (
            w.invoice_no, w.date, w.amount, w.level, w.font)


def test_fixture_cases_round_trip_through_save_and_load(fix, tmp_path):
    assert os.path.getsize(FIXTURE) <= 6_000_000
    assert len(fix["cases"]) == 9 and len(dict.fromkeys(fix["tiers"])) == 9
    path = str(tmp_path / "cases.npz")
    save_cases(path, fix["cases"], tiers=np.asarray(fix["tiers"]))
    assert_cases_equal(load_cases(path), fix["cases"])
    with np.load(path) as z:
        assert z["tiers"].tolist() == fix["tiers"]
    odd = fix["cases"][0]
    grey = odd.mask.copy()
    grey[0, 0, 0] = 128  # not 0/255: stored as it is, not as bits
    save_cases(path, [odd, GauntletCase(odd.image, grey, "", "", 0)])
    assert_cases_equal(load_cases(path)[1:], [GauntletCase(odd.image, grey, "", "", 0)])
    with pytest.raises(ValueError, match="clash"):
        save_cases(path, [odd], case0_image=np.zeros(1))


def test_fixture_reproduces_from_its_script(fix):
    """The cases re-render equal; the JAX w16 fp32 route gives the stored
    results again (the other routes' reruns cost a w64 JAX compile: the
    script regenerates them, not this test)."""
    mod = _script()
    cases, tiers = mod.render_cases()
    assert tiers.tolist() == fix["tiers"]
    assert_cases_equal([port_case(c) for c in cases], fix["cases"])
    import jax.numpy as jnp

    from twinvoice_tpu.config import InferConfig
    from twinvoice_tpu.infer.pipeline import Segmenter
    from twinvoice_tpu.models.pretrained import VARIANTS, variant_path
    from twinvoice_tpu.train.checkpoint import load_params_npz

    mcfg = VARIANTS["w16"][1]
    seg = Segmenter(*load_params_npz(variant_path("w16"), mcfg), mcfg,
                    InferConfig(img_size=512), dtype=jnp.float32)
    got = mod.jax_route(seg, cases, tiers)
    for k, v in got.items():
        want = fix[f"w16_fp32_{k}"]
        if k == "summary":
            assert json.loads(str(v)) == want
        else:
            np.testing.assert_array_equal(v, want, err_msg=k)


def port_case(c):
    return GauntletCase(c.image, c.mask, c.invoice_no, c.date, c.amount, c.level, c.font)


@pytest.mark.parametrize("route", list(chip_smoke.GAUNTLET_ROUTES))
def test_port_gauntlet_on_cpu_holds_to_jax(fix, route):
    seg = chip_smoke.gauntlet_segmenter(route, fix, device="cpu")
    got = chip_smoke.gauntlet_run(seg, fix)
    d_iou, px, eq, total = chip_smoke.gauntlet_compare(route, fix, got)
    assert eq == total == 27  # every box and ok flag is JAX's on the CPU
    if route in ("w16_fp32", "w16_int8"):  # exact on the CPU
        assert d_iou == 0 and px == 0
        assert got["summary"] == fix[f"{route}_summary"]
        for k in ("iou", "hit", "boxes", "ok"):
            np.testing.assert_array_equal(got[k], fix[f"{route}_{k}"], err_msg=k)
    else:
        assert d_iou <= chip_smoke.GAUNTLET_IOU_TOL[route] / 10


def test_e2e_fields_equal_jax_on_cpu(fix):
    assert chip_smoke.e2e_check(fix, "CPU", device="cpu") == {}
