"""PyTorch port: ``tests/data/torch_smoke_render.npz`` (phase 31's fixture,
made by ``scripts/make_torch_smoke_render.py``) held against Pillow and the
JAX renderers, and phase 31's checks run on the CPU.

- the fixture is what Pillow and the JAX package render on the CPU (the glyph
  sheet, the default-font sheet, the three batches and four pages, the
  generator's states), with OpenCV's own code (``cv2.ipp.setUseIPP(False)``)
  and JAX's registry cut to the fixture's 13 bundled faces;
- ``chip_smoke.render_sheet_check``: 0 bytes differ, for every face and
  for Pillow's default font;
- ``chip_smoke.render_batches_check``: the port's batches and pages equal
  the fixture's;
- ``chip_smoke.train_ocr_cli_check`` (``train-ocr`` without ``--pool`` at
  101 steps of one line) and ``textness_own_pages_check`` on the CPU.
"""

import json
import os

import cv2
import numpy as np
from PIL import ImageFont

import chip_smoke
import twinvoice_tpu.data.synthetic as jax_synthetic
import twinvoice_tpu.ocr.jaxocr.data as J
from twinvoice_tpu.ocr.jaxocr import textness as JT
from twinvoice_tpu.ocr.jaxocr.charset import cjk_charset

FIX = chip_smoke.render_fixture()


def test_fixture_is_pillow_and_jax(monkeypatch):
    paths = {os.path.basename(p): p for p in jax_synthetic.train_fonts()}
    meta, buf, i = FIX["sheet_meta"], FIX["sheet_buf"], 0
    for name in FIX["sheet_fonts"]:
        for size in range(10, 30):
            font = ImageFont.truetype(paths[name], size)
            for ch in FIX["sheet_chars"]:
                off, h, w, xo, yo, length = (int(v) for v in meta[i])
                m, offset = font.getmask2(ch, "L")
                got = np.array(m, np.uint8).reshape(m.size[1], m.size[0])
                assert got.shape == (h, w) and offset == (xo, yo), (name, size, ch)
                assert np.array_equal(got, buf[off:off + h * w].reshape(h, w)), (name, size, ch)
                assert round(font.getlength(ch) * 64) == length
                i += 1
    assert i == len(meta)
    default = ImageFont.load_default()
    for k, ch in enumerate(FIX["dsheet_chars"]):
        off, h, w, xo, yo, length = (int(v) for v in FIX["dsheet_meta"][k])
        m, offset = default.getmask2(ch, "L")
        got = np.array(m, np.uint8).reshape(m.size[1], m.size[0])
        assert got.shape == (h, w) and offset == (xo, yo), ch
        assert np.array_equal(got, FIX["dsheet_buf"][off:off + h * w].reshape(h, w)), ch
        assert round(default.getlength(ch) * 64) == length
    reg = [paths[n] for n in FIX["registry"]]
    assert FIX["registry"] == FIX["sheet_fonts"] and len(reg) == 13
    monkeypatch.setattr(J, "_FONT_PATHS", reg)
    monkeypatch.setattr(jax_synthetic, "train_fonts", lambda: reg)
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        for k, kw in enumerate(FIX["batch_kwargs"]):
            kw = dict(kw)
            rng = np.random.default_rng(kw.pop("seed"))
            charset = cjk_charset() if kw.pop("cjk", False) else J.DEFAULT
            imgs, labels, pad, texts = J.make_batch(len(FIX[f"b{k}_lines"]), rng, charset, **kw)
            assert np.array_equal(imgs[..., 0], FIX[f"b{k}_lines"].astype(np.float32) / 255.0)
            assert np.array_equal(labels, FIX[f"b{k}_labels"])
            assert np.array_equal(pad, FIX[f"b{k}_pad"])
            assert texts == [str(t) for t in FIX[f"b{k}_texts"]]
            assert json.dumps(rng.bit_generator.state) == str(FIX[f"b{k}_state"])
        rng = np.random.default_rng(3)
        for j in range(len(FIX["pages"])):
            page, mask = JT.render_textpage(rng)
            assert np.array_equal(page, FIX["pages"][j]) and np.array_equal(mask, FIX["masks"][j])
        assert json.dumps(rng.bit_generator.state) == str(FIX["pages_state"])
    finally:
        cv2.ipp.setUseIPP(was)


def test_port_renders_the_fixture():
    sheet, us = chip_smoke.render_sheet_check(FIX)
    assert us > 0 and len(sheet) == 14
    for name, (glyphs, bad, nbytes) in sheet.items():
        assert glyphs in (20 * len(FIX["sheet_chars"]), len(FIX["dsheet_chars"]))
        assert bad == 0 and nbytes == 0, name
    with chip_smoke.render_registry(FIX["registry"]):
        line_ms, batch_ms, page_ms = chip_smoke.render_batches_check(FIX)
    assert 0 < line_ms < batch_ms and page_ms > 0


def test_trainers_draw_their_own_data_on_the_cpu(tmp_path):
    """On one intra-op thread, as the CLI's 101-step test runs: the test
    workers share the machine's cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        secs, eng = chip_smoke.train_ocr_cli_check(str(tmp_path), device="cpu", batch=1)
        assert secs > 0 and eng.available()
        secs, params = chip_smoke.textness_own_pages_check(device="cpu", steps=2, bs=2, pool=1)
        assert len(params) == 5
    finally:
        torch.set_num_threads(n)
