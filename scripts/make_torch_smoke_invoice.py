"""Make ``tests/data/torch_smoke_invoice.npz``: the fixture that holds the
PyTorch port's invoice renderer and the gauntlet it feeds against the JAX
package's, on the card (``chip_smoke.py`` phase 32) and on the CPU
(``tests/test_torch_fixture_invoice.py``).

Everything is drawn by the JAX package (Pillow 12.1.0 with FreeType 2.14.1,
raqm 0.10.3, HarfBuzz 12.3.0; OpenCV 5.0 with ``cv2.ipp.setUseIPP(False)``)
on the card's registries: the 13 bundled training faces and the 6 bundled
held-out faces (a machine with gymnasium and pygame adds Minecraft and
Liberation Sans, which the card's machine lacks), by file name in
``train_registry`` and ``heldout_registry``. No JAX file is edited: the JAX
gauntlet's registry functions are replaced at run time.

Stored (digests are SHA-256 of the C-ordered bytes, hex):

- the knob grid (``GRID``, JSON ``grid_kwargs`` with fonts by file name):
  ``render_invoice``'s defaults; each face of both registries once at a
  size in 18–26; ``layout_jitter`` 0.6 and 1.0; ``stylize`` 0.5 (seed 0
  erodes, seed 10 dilates) and 1.0 (seed 0 does both); ``gt_anchor="cursor"``;
  ``dot_print``; the sizes (360, 560) and (559, 759); items with CJK names.
  ``grid_sha`` (N,) the page digests, ``grid_boxes`` (N, 3, 4) int32 the
  boxes in ``FIELDS`` order, and the full RGB pages of ``grid_full`` (the
  first two calls) as ``grid_page{i}``;
- the gauntlet's base cases, ``make_base_cases(25)`` for the three bases of
  ``scripts/eval_gauntlet.py`` (``std``, ``heldout`` seed 888 000, ``dot``
  seed 999 000 with ``dot_print``): ``{base}_image_sha``,
  ``{base}_mask_sha`` (25,) and ``{base}_content`` (JSON: invoice number,
  date, amount, font file);
- its eleven tiers (``LEVEL_SETS``, ``perturb_cases(..., seed=7)``):
  ``tiers`` (275,) the tier of each case in order, ``tier_image_sha`` and
  ``tier_mask_sha`` (275,);
- the JAX ``run_segmenter_gauntlet`` tier by tier on the w16 at float32
  and the w16 int8 (calibrated on the first 8 clean training-font cases, as
  ``eval_gauntlet.py`` does; ``int8_scales`` in ``infer.quant``'s array
  order): ``{route}_iou`` (275, 3) float64, ``{route}_hit`` and
  ``{route}_ok`` (275, 3) bool, ``{route}_boxes`` (275, 3, 4) int32 and
  ``{route}_summary`` (JSON, the function's dict per tier);
- the JAX extractor on the three clean tiers (75 pages; the w16 at
  bfloat16, ``JaxOcrEngine()``, ``FusionConfig(use_qr=False,
  auto_rotate=False)`` as ``eval_gauntlet.py --e2e``): ``e2e_cases`` the
  case indices, ``e2e_records`` (JSON, ``chip_smoke.fusion_record`` of each),
  ``e2e_summary`` (JSON per tier), ``e2e_boxes``/``e2e_ok`` of the
  extractor's segmenter calls (Pillow's bicubic resize);
- ``jax_host`` and ``jax_ms``: the CPU that made the fixture and the JAX
  renderer's ms a page (plain, stylized at 1.0, dot-matrix) and a base case
  (each base), which phase 32 prints beside the port's.

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_invoice.py    # ~5 min
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_smoke_invoice.npz")
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from eval_torch_gauntlet import BASES, LEVEL_SETS, _BASE_SUFFIX as SUFFIX  # noqa: E402

N_CASES = 25      # eval_gauntlet.py's --n
PERTURB_SEED = 7  # eval_gauntlet.py's
ROUTES = ("w16_fp32", "w16_int8")
FULL_PAGES = 2
CJK_ITEMS = [{"name": "測試品項", "qty": 1, "price": 120},
             {"name": "奶茶", "qty": 2, "price": 30}]
# the port's registries on the card's machine (bundled faces only)
TRAIN_REGISTRY = ("DejaVuSansMono.ttf", "DejaVuSans.ttf", "DejaVuSerif.ttf",
                  "DejaVuSansMono-Bold.ttf", "DejaVuSans-Bold.ttf", "DejaVuSans-Oblique.ttf",
                  "DejaVuSans-BoldOblique.ttf", "DejaVuSansMono-Oblique.ttf",
                  "DejaVuSansMono-BoldOblique.ttf", "DejaVuSerif-Bold.ttf",
                  "DejaVuSerif-Italic.ttf", "DejaVuSerif-BoldItalic.ttf",
                  "AtkinsonHyperlegibleNext[wght].ttf")
HELDOUT_REGISTRY = ("STIXGeneral.ttf", "STIXGeneralBol.ttf", "cmr10.ttf", "cmss10.ttf",
                    "freesansbold.ttf", "PlayfairDisplaySemibold.ttf")


def grid():
    """The knob grid: ``render_invoice`` keyword arguments, fonts by name."""
    calls = [{}, {"dot_print": True, "seed": 2}]
    sizes = list(range(18, 27))
    for i, name in enumerate(TRAIN_REGISTRY + HELDOUT_REGISTRY):
        calls.append({"font": name, "font_size": sizes[i % len(sizes)], "seed": 100 + i,
                      "invoice_no": "QZ98765432", "date_iso": "2031-12-28", "amount": 99998})
    calls += [{"layout_jitter": 0.6, "seed": 3}, {"layout_jitter": 1.0, "seed": 7},
              {"stylize": 0.5, "seed": 0}, {"stylize": 0.5, "seed": 10},
              {"stylize": 1.0, "seed": 0}, {"stylize": 1.0, "seed": 5, "layout_jitter": 0.6},
              {"gt_anchor": "cursor", "seed": 4},
              {"size": [360, 560], "seed": 8}, {"size": [559, 759], "seed": 9},
              {"items": CJK_ITEMS, "seed": 6, "amount": 180}]
    return calls


def digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def resolve(kw, paths):
    """``render_invoice`` arguments: the font name to a path in ``paths``."""
    kw = dict(kw)
    if "font" in kw:
        kw["font_path"] = paths[kw.pop("font")]
    if "size" in kw:
        kw["size"] = tuple(kw["size"])
    return kw


def jax_paths():
    """File name → the JAX package's path, over both of its registries."""
    from twinvoice_tpu.data.synthetic import heldout_fonts, train_fonts

    return {os.path.basename(p): p for p in train_fonts() + heldout_fonts()}


def cut_jax_registries(paths):
    """The JAX gauntlet's registries cut to the card's, by name and order."""
    from twinvoice_tpu.eval import gauntlet

    train = [paths[n] for n in TRAIN_REGISTRY]
    held = [paths[n] for n in HELDOUT_REGISTRY]
    gauntlet.train_fonts = lambda: list(train)
    gauntlet.heldout_fonts = lambda: list(held)


def render_grid(paths):
    from twinvoice_tpu import FIELDS
    from twinvoice_tpu.data.synthetic import render_invoice

    out, boxes, pages = [], [], []
    for i, kw in enumerate(grid()):
        img, bx = render_invoice(**resolve(kw, paths))
        a = np.asarray(img)
        out.append(digest(a))
        boxes.append([bx[f] for f in FIELDS])
        if i < FULL_PAGES:
            pages.append(a)
    return np.asarray(out), np.asarray(boxes, np.int32), pages


def base_and_tiers():
    from twinvoice_tpu.eval.gauntlet import make_base_cases, perturb_cases

    stored, bases, ms = {}, {}, {}
    for base, kw in BASES.items():
        t0 = time.perf_counter()
        bases[base] = make_base_cases(N_CASES, **kw)
        ms[f"case_{base}"] = (time.perf_counter() - t0) * 1e3 / N_CASES
        stored[f"{base}_image_sha"] = np.asarray([digest(c.image) for c in bases[base]])
        stored[f"{base}_mask_sha"] = np.asarray([digest(c.mask) for c in bases[base]])
        stored[f"{base}_content"] = np.asarray(json.dumps(
            [[c.invoice_no, c.date, c.amount, c.font] for c in bases[base]]))
    cases, tiers = [], []
    for level, base in LEVEL_SETS:
        for c in perturb_cases(bases[base], level, seed=PERTURB_SEED):
            cases.append(c)
            tiers.append(level + SUFFIX[base])
    stored["tiers"] = np.asarray(tiers)
    stored["tier_image_sha"] = np.asarray([digest(c.image) for c in cases])
    stored["tier_mask_sha"] = np.asarray([digest(c.mask) for c in cases])
    return stored, cases, tiers, ms


def routes(cases, tiers):
    """The JAX gauntlet on the w16 fp32 and int8 routes, per case."""
    import jax.numpy as jnp
    import make_torch_smoke_gauntlet as G

    from twinvoice_tpu.config import InferConfig
    from twinvoice_tpu.eval.gauntlet import _resize_case
    from twinvoice_tpu.infer import quant
    from twinvoice_tpu.infer.pipeline import Segmenter
    from twinvoice_tpu.models.pretrained import VARIANTS, variant_path
    from twinvoice_tpu.models.unet import fold_unet
    from twinvoice_tpu.train.checkpoint import load_params_npz
    from twinvoice_tpu_torch.infer.quant import scales_to_array

    w16 = load_params_npz(variant_path("w16"), VARIANTS["w16"][1])
    icfg = InferConfig(img_size=512)
    clean = [c for c, t in zip(cases, tiers) if t == "clean"][:8]
    calib = [np.stack([_resize_case(c, 512)[0] for c in clean]).astype(np.uint8)]
    scales = scales_to_array(quant.calibrate(fold_unet(*w16, cfg=VARIANTS["w16"][1]), calib))
    segs = {"w16_fp32": Segmenter(*w16, VARIANTS["w16"][1], icfg, dtype=jnp.float32),
            "w16_int8": Segmenter(*w16, VARIANTS["w16"][1], icfg, dtype=jnp.bfloat16,
                                  int8_calib=calib),
            "w16_bf16": Segmenter(*w16, VARIANTS["w16"][1], icfg, dtype=jnp.bfloat16)}
    out = {"int8_scales": scales}
    for route in ROUTES:
        res = G.jax_route(segs[route], cases, np.asarray(tiers))
        for k in ("iou", "hit", "ok", "boxes", "summary"):
            out[f"{route}_{k}"] = res[k]
        print(route, json.loads(str(res["summary"])), flush=True)
    return out, segs["w16_bf16"]


def e2e(seg, cases, tiers):
    """The JAX extractor on the three clean tiers."""
    import jax.numpy as jnp
    from PIL import Image

    from chip_smoke import fusion_record
    from twinvoice_tpu.config import FusionConfig
    from twinvoice_tpu.eval.gauntlet import run_e2e_gauntlet
    from twinvoice_tpu.fusion.extract import InvoiceExtractor
    from twinvoice_tpu.ocr.jaxocr.engine import JaxOcrEngine

    ex = InvoiceExtractor(seg, None, engines=[JaxOcrEngine()],
                          cfg=FusionConfig(use_qr=False, auto_rotate=False))
    clean = [t for t in dict.fromkeys(tiers) if t.startswith("clean")]
    idx = [i for i, t in enumerate(tiers) if t in clean]
    summary = {t: run_e2e_gauntlet(ex, [cases[i] for i in idx if tiers[i] == t]) for t in clean}
    records, boxes, ok = [], [], []
    size = seg.cfg.img_size
    for i in idx:
        ex.clear_cache()
        page = cases[i].image
        records.append(fusion_record(*ex.extract(Image.fromarray(page))))
        small = np.asarray(Image.fromarray(page).resize((size, size)), np.uint8)[None]
        sz = np.asarray([[page.shape[1], page.shape[0]]], np.int32)
        _, bx, o = seg._run(seg._serve_params, jnp.asarray(small), jnp.asarray(sz))
        boxes.append(np.asarray(bx)[0])
        ok.append(np.asarray(o)[0])
    print("e2e", summary, flush=True)
    return {"e2e_cases": np.asarray(idx, np.int64),
            "e2e_records": np.asarray(json.dumps(records, ensure_ascii=False)),
            "e2e_summary": np.asarray(json.dumps(summary)),
            "e2e_boxes": np.stack(boxes).astype(np.int32),
            "e2e_ok": np.stack(ok).astype(bool)}


def page_ms(paths):
    """The JAX renderer's ms a page: plain, stylized at 1.0, dot-matrix."""
    from twinvoice_tpu.data.synthetic import render_invoice

    out = {}
    for name, kw in (("plain", {}), ("stylized", {"stylize": 1.0}), ("dot", {"dot_print": True})):
        t0 = time.perf_counter()
        for seed in range(8):
            render_invoice(seed=seed, **kw)
        out[f"page_{name}"] = (time.perf_counter() - t0) * 1e3 / 8
    return out


def main():
    sys.path.insert(0, ROOT)
    import cv2

    from chip_smoke import host_cpu

    cv2.ipp.setUseIPP(False)  # OpenCV's own code, which the port follows
    paths = jax_paths()
    missing = [n for n in TRAIN_REGISTRY + HELDOUT_REGISTRY if n not in paths]
    if missing:
        raise SystemExit(f"the JAX registries here lack {missing}")
    cut_jax_registries(paths)
    sha, boxes, pages = render_grid(paths)
    stored, cases, tiers, ms = base_and_tiers()
    ms.update(page_ms(paths))
    ref, seg_bf16 = routes(cases, tiers)
    out = dict(stored, **ref, **e2e(seg_bf16, cases, tiers))
    out.update({f"grid_page{i}": p for i, p in enumerate(pages)})
    np.savez_compressed(
        OUT, grid_kwargs=np.asarray(json.dumps(grid(), ensure_ascii=False)), grid_sha=sha,
        grid_boxes=boxes, grid_full=np.arange(len(pages)),
        train_registry=np.asarray(TRAIN_REGISTRY), heldout_registry=np.asarray(HELDOUT_REGISTRY),
        jax_host=np.asarray(host_cpu()), jax_ms=np.asarray(json.dumps(ms)), **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes); JAX ms {ms}")


if __name__ == "__main__":
    main()
