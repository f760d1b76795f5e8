"""Make ``tests/data/torch_smoke_render.npz``: the fixture that holds the
PyTorch port's text rendering against Pillow and the JAX renderers, on the
card's host (``chip_smoke.py`` phase 31) and on the CPU
(``tests/test_torch_fixture_render.py``).

Stored, all from Pillow 12.1.0 (FreeType 2.14.1, raqm 0.10.3, HarfBuzz
12.3.0) and the JAX package where it runs:

- the glyph sheet: for each of the 13 bundled training fonts
  (``sheet_fonts``, by file name: the twelve DejaVu faces and Atkinson
  Hyperlegible Next), each size 10–29 and each charset character, Pillow's
  ``getmask2(ch, "L")`` mask (``sheet_buf``, concatenated), its offset and
  ``getlength`` in 1/64 px (``sheet_meta`` (N, 6): buffer offset, height,
  width, x offset, y offset, length);
- the default-font sheet: the same for Pillow's ``ImageFont.load_default()``
  (its Aileron subset at size 10, BASIC layout) and every printable ASCII
  character (``dsheet_chars``, ``dsheet_buf``, ``dsheet_meta``);
- three recognizer batches from the JAX package's ``make_batch`` (16 lines
  each, uint8, labels, pads, texts, and the generator's state after):
  ``b0`` the default (seed 0), ``b1`` every fraction (seed 1), ``b2`` the
  CJK charset with the mixed and hard samplers (seed 2); ``batch_kwargs``;
- four textness pages and masks from ``render_textpage`` in a row (seed 3)
  and the generator's state after;
- the JAX renderers' host seconds on the CPU that made the fixture
  (``jax_host``): ``make_batch(64, default_rng(0))`` (``jax_batch64_s``) and
  a ``render_textpage`` page (``jax_page_s``, the mean of 8), which phase 31
  prints beside the port's.

The batches and pages are drawn with JAX's registry cut, at run time, to the
13 bundled faces (``registry``), the port's registry on a machine without
gymnasium's Minecraft font, such as the card's. OpenCV runs with
``cv2.ipp.setUseIPP(False)``: with IPP, its float resizes differ in the last
bits from OpenCV's own code, which the port follows. No JAX file is edited.

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_render.py    # ~10 s
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_smoke_render.npz")
SIZES = range(10, 30)
LINES = 16
PAGES = 4
BATCH_KWARGS = (
    {"seed": 0},
    {"seed": 1, "hard_frac": 0.2, "sev_frac": 0.3, "dot_frac": 0.4, "synth_frac": 0.3,
     "dot_hard_frac": 0.4},
    {"seed": 2, "cjk": True, "mixed_frac": 0.3, "hard_frac": 0.2, "dot_frac": 0.2},
)


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip() + f", {os.cpu_count()} cores"
    except OSError:
        pass
    return f"model name not given, {os.cpu_count()} cores"


def main():
    sys.path.insert(0, ROOT)
    import cv2
    from PIL import ImageFont

    import twinvoice_tpu.data.synthetic as synthetic
    import twinvoice_tpu.ocr.jaxocr.data as D
    from twinvoice_tpu.ocr.jaxocr import textness
    from twinvoice_tpu.ocr.jaxocr.charset import CHARSET, cjk_charset
    from twinvoice_tpu_torch.data.synthetic import BUNDLED_FONTS

    cv2.ipp.setUseIPP(False)
    bundled = {f for f in os.listdir(BUNDLED_FONTS) if f.endswith(".ttf")}
    fonts = [p for p in synthetic.train_fonts() if os.path.basename(p) in bundled]
    assert len(fonts) == 13, fonts
    out = {"sheet_fonts": np.array([os.path.basename(p) for p in fonts]),
           "sheet_chars": np.array(CHARSET)}
    buf, meta = [], []
    pos = 0
    for path in fonts:
        for size in SIZES:
            font = ImageFont.truetype(path, size)
            for ch in CHARSET:
                m, (xo, yo) = font.getmask2(ch, "L")
                a = np.array(m, np.uint8).reshape(m.size[1], m.size[0])
                buf.append(a.ravel())
                meta.append((pos, a.shape[0], a.shape[1], xo, yo,
                             int(round(font.getlength(ch) * 64))))
                pos += a.size
    out["sheet_buf"] = np.concatenate(buf)
    out["sheet_meta"] = np.array(meta, np.int32)
    default = ImageFont.load_default()
    ascii_chars = "".join(chr(c) for c in range(0x20, 0x7F))
    buf, meta, pos = [], [], 0
    for ch in ascii_chars:
        m, (xo, yo) = default.getmask2(ch, "L")
        a = np.array(m, np.uint8).reshape(m.size[1], m.size[0])
        buf.append(a.ravel())
        meta.append((pos, a.shape[0], a.shape[1], xo, yo, int(round(default.getlength(ch) * 64))))
        pos += a.size
    out["dsheet_chars"] = np.array(ascii_chars)
    out["dsheet_buf"] = np.concatenate(buf)
    out["dsheet_meta"] = np.array(meta, np.int32)

    D._FONT_PATHS = fonts
    synthetic.train_fonts = lambda: fonts
    out["registry"] = np.array([os.path.basename(p) for p in fonts])
    for k, kw in enumerate(BATCH_KWARGS):
        kw = dict(kw)
        rng = np.random.default_rng(kw.pop("seed"))
        charset = cjk_charset() if kw.pop("cjk", False) else D.DEFAULT
        imgs, labels, pad, texts = D.make_batch(LINES, rng, charset, **kw)
        lines = np.rint(imgs[..., 0] * 255).astype(np.uint8)
        assert np.array_equal(lines.astype(np.float32) / 255.0, imgs[..., 0])
        out[f"b{k}_lines"], out[f"b{k}_labels"], out[f"b{k}_pad"] = lines, labels, pad
        out[f"b{k}_texts"] = np.array(texts)
        out[f"b{k}_state"] = np.array(json.dumps(rng.bit_generator.state))
    out["batch_kwargs"] = np.array(json.dumps(BATCH_KWARGS))
    rng = np.random.default_rng(3)
    pages = [textness.render_textpage(rng) for _ in range(PAGES)]
    out["pages"] = np.stack([p for p, _ in pages])
    out["masks"] = np.stack([m for _, m in pages])
    out["pages_state"] = np.array(json.dumps(rng.bit_generator.state))
    t0 = time.perf_counter()
    D.make_batch(64, np.random.default_rng(0))
    out["jax_batch64_s"] = np.float64(time.perf_counter() - t0)
    rng = np.random.default_rng(4)
    t0 = time.perf_counter()
    for _ in range(8):
        textness.render_textpage(rng)
    out["jax_page_s"] = np.float64((time.perf_counter() - t0) / 8)
    out["jax_host"] = np.array(_cpu_model())
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 2 ** 20:.2f} MiB): {len(out['sheet_meta'])} + "
          f"{len(out['dsheet_meta'])} glyphs, "
          f"{len(BATCH_KWARGS)} batches of {LINES}, {PAGES} pages; JAX: "
          f"{float(out['jax_batch64_s']):.3f} s a b64 batch, {float(out['jax_page_s']):.4f} s a page "
          f"({out['jax_host']})")


if __name__ == "__main__":
    main()
