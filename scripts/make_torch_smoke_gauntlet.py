"""Make ``tests/data/torch_smoke_gauntlet.npz``: the fixture that holds the
PyTorch port's gauntlet (``twinvoice_tpu_torch.eval``) against the JAX
package's on the card (``chip_smoke.py`` phase 26).

Cases: the JAX package's ``make_base_cases(1)`` on the training fonts and
``make_base_cases(1, seed=888_000, use_heldout_fonts=True)`` on the held-out
ones (the first case of ``scripts/eval_gauntlet.py``'s base sets), perturbed
with ``perturb_cases(..., seed=7)`` as that script does, in the nine tiers of
:data:`TIERS`: nine cases, written with the port's ``eval.save_cases``. Two
cases a tier would make a 7.5 MB file (the perturbed photos' noise does not
compress), so there is one a tier.

Routes (:data:`ROUTES`), each a JAX ``Segmenter`` on bundled weights at the
512² grid, run through the JAX ``run_segmenter_gauntlet`` tier by tier:

- ``w16_fp32``: the w16 at float32 (the parity referee);
- ``w16_bf16``: the w16 at bfloat16 (what ``eval_gauntlet.py`` serves);
- ``w16_int8``: the w16 int8 (its masks path: the concat trunk), calibrated
  on the clean training-font cases as ``eval_gauntlet.py``'s
  ``calib_batches`` does;
- ``w64_bf16``: the w64 at bfloat16.

Stored per route: ``<route>_iou`` (9, 3) float64 and ``<route>_hit`` (9, 3)
bool, each case's IoU and box hit (the JAX formulas, whose tier means must
equal the JAX function's), ``<route>_boxes`` (9, 3, 4) int32,
``<route>_ok`` (9, 3) bool, ``<route>_mask`` the predicted (9, 512, 512,
3) masks as packed bits, and ``<route>_summary`` a JSON string of the JAX
function's dict for each tier. Also ``tiers`` (9,) str, ``int8_scales``
float64 (JAX's calibrated scales in ``infer.quant.scales_to_array`` order),
and for the end-to-end run on the clean and mild training-font tiers (the
w16 at bfloat16, ``JaxOcrEngine()``, ``FusionConfig(use_qr=False,
auto_rotate=False)``, as ``eval_gauntlet.py --e2e``): ``e2e_cases`` (2,) the
case indices, ``e2e_records`` a JSON string of each case's
``chip_smoke.fusion_record``, ``e2e_summary`` a JSON string of the JAX
``run_e2e_gauntlet`` dict per tier, and ``e2e_boxes``/``e2e_ok`` the boxes
of the extractor's ``segment_pil`` calls (Pillow's bicubic resize).

The cases are made with ``cv2.ipp.setUseIPP(False)``.

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_gauntlet.py
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_smoke_gauntlet.npz")

N_BASE = 1              # base cases a font set (two would pass 6 MB)
PERTURB_SEED = 7        # eval_gauntlet.py's
HELDOUT_SEED = 888_000  # eval_gauntlet.py's held-out base seed
TIERS = (("clean", "std"), ("mild", "std"), ("hard", "std"),
         ("printscan", "std"), ("screenshot", "std"), ("crumple", "std"),
         ("thermal", "std"), ("clean", "heldout"), ("mild", "heldout"))
E2E_TIERS = ("clean", "mild")  # on the training fonts
ROUTES = ("w16_fp32", "w16_bf16", "w16_int8", "w64_bf16")


def tier_name(level, base):
    return level + ("+heldoutfont" if base == "heldout" else "")


def render_cases():
    """→ (cases, tiers): the JAX ``GauntletCase`` objects, tier by tier, with
    OpenCV's own code (IPP off: with Intel IPP, the wheel's default, its
    float cubic resize differs in the last bits from the code the port
    follows)."""
    import cv2

    from twinvoice_tpu.eval.gauntlet import make_base_cases, perturb_cases

    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        bases = {"std": make_base_cases(N_BASE, use_heldout_fonts=False),
                 "heldout": make_base_cases(N_BASE, seed=HELDOUT_SEED,
                                            use_heldout_fonts=True)}
        cases, tiers = [], []
        for level, base in TIERS:
            for c in perturb_cases(bases[base], level, seed=PERTURB_SEED):
                cases.append(c)
                tiers.append(tier_name(level, base))
    finally:
        cv2.ipp.setUseIPP(was)
    return cases, np.asarray(tiers)


class Recorder:
    """A segmenter that passes ``segment_batch`` on and keeps its outputs."""

    def __init__(self, seg):
        self.seg, self.cfg, self.out = seg, seg.cfg, []

    def segment_batch(self, imgs, sizes):
        out = self.seg.segment_batch(imgs, sizes)
        self.out.append(tuple(np.asarray(o) for o in out))
        return out


def case_scores(cases, pred, boxes, ok):
    """Each case's IoU and box hit: the formulas of the JAX
    ``run_segmenter_gauntlet``, kept per case."""
    from twinvoice_tpu.data.augment import boxes_from_mask
    from twinvoice_tpu.eval.gauntlet import _resize_case

    size = pred.shape[1]
    gts = np.stack([_resize_case(c, size)[1] > 127 for c in cases])
    inter = (pred & gts).sum((1, 2)).astype(np.float64)
    union = (pred | gts).sum((1, 2)).astype(np.float64)
    iou = inter / np.maximum(union, 1.0)
    hits = np.zeros((len(cases), 3), bool)
    for i, c in enumerate(cases):
        gt = boxes_from_mask(c.mask)
        for f in range(3):
            if f not in gt:
                hits[i, f] = not ok[i, f]
                continue
            if not ok[i, f]:
                continue
            gx1, gy1, gx2, gy2 = gt[f]
            px1, py1, px2, py2 = boxes[i, f]
            ia = max(0, min(gx2, px2) - max(gx1, px1)) * max(0, min(gy2, py2) - max(gy1, py1))
            hits[i, f] = ia / max(1, (gx2 - gx1) * (gy2 - gy1)) >= 0.7
    return iou, hits


def segmenters(cases, tiers):
    """→ {route: JAX Segmenter}, and JAX's int8 scales."""
    import jax.numpy as jnp

    from twinvoice_tpu.config import InferConfig
    from twinvoice_tpu.eval.gauntlet import _resize_case
    from twinvoice_tpu.infer import quant
    from twinvoice_tpu.infer.pipeline import Segmenter
    from twinvoice_tpu.models.pretrained import VARIANTS, variant_path
    from twinvoice_tpu.models.unet import fold_unet
    from twinvoice_tpu.train.checkpoint import load_params_npz
    from twinvoice_tpu_torch.infer.quant import scales_to_array

    w16 = load_params_npz(variant_path("w16"), VARIANTS["w16"][1])
    w64 = load_params_npz(variant_path("w64"), VARIANTS["w64"][1])
    icfg = InferConfig(img_size=512)
    # eval_gauntlet.py's calib_batches: the clean training-font cases
    clean = [c for c, t in zip(cases, tiers) if t == "clean"][:8]
    calib = [np.stack([_resize_case(c, 512)[0] for c in clean]).astype(np.uint8)]
    folded32 = fold_unet(*w16, cfg=VARIANTS["w16"][1])
    scales = scales_to_array(quant.calibrate(folded32, calib))
    segs = {
        "w16_fp32": Segmenter(*w16, VARIANTS["w16"][1], icfg, dtype=jnp.float32),
        "w16_bf16": Segmenter(*w16, VARIANTS["w16"][1], icfg, dtype=jnp.bfloat16),
        "w16_int8": Segmenter(*w16, VARIANTS["w16"][1], icfg, dtype=jnp.bfloat16,
                              int8_calib=calib),
        "w64_bf16": Segmenter(*w64, VARIANTS["w64"][1], icfg, dtype=jnp.bfloat16),
    }
    return segs, scales


def jax_route(seg, cases, tiers) -> dict:
    """The JAX gauntlet tier by tier on one segmenter (module doc)."""
    from twinvoice_tpu.eval.gauntlet import run_segmenter_gauntlet

    rec = Recorder(seg)
    summary, scores = {}, []
    for t in dict.fromkeys(tiers):
        sel = [c for c, tt in zip(cases, tiers) if tt == t]
        res = run_segmenter_gauntlet(rec, sel)
        pred, boxes, ok = rec.out[-1]
        iou, hits = case_scores(sel, pred, boxes, ok)
        if iou.mean(0).tolist() != res["iou"] or hits.mean(0).tolist() != res["box_hit"]:
            raise AssertionError(f"{t}: per-case scores {iou}, {hits} do not give {res}")
        summary[t] = res
        scores.append((iou, hits))
    pred, boxes, ok = (np.concatenate(a) for a in zip(*rec.out))
    return {"iou": np.concatenate([s[0] for s in scores]),
            "hit": np.concatenate([s[1] for s in scores]),
            "boxes": boxes.astype(np.int32), "ok": ok.astype(bool),
            "mask": np.packbits(pred.astype(bool)),
            "summary": np.asarray(json.dumps(summary))}


def jax_e2e(seg, cases, tiers) -> dict:
    """The JAX extractor on the clean and mild training-font tiers."""
    import jax.numpy as jnp
    from PIL import Image

    from chip_smoke import fusion_record
    from twinvoice_tpu.config import FusionConfig
    from twinvoice_tpu.eval.gauntlet import run_e2e_gauntlet
    from twinvoice_tpu.fusion.extract import InvoiceExtractor
    from twinvoice_tpu.ocr.jaxocr.engine import JaxOcrEngine

    ex = InvoiceExtractor(seg, None, engines=[JaxOcrEngine()],
                          cfg=FusionConfig(use_qr=False, auto_rotate=False))
    idx = [i for i, t in enumerate(tiers) if t in E2E_TIERS]
    summary = {t: run_e2e_gauntlet(ex, [cases[i] for i in idx if tiers[i] == t])
               for t in E2E_TIERS}
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
    return {"e2e_cases": np.asarray(idx, np.int64),
            "e2e_records": np.asarray(json.dumps(records, ensure_ascii=False)),
            "e2e_summary": np.asarray(json.dumps(summary)),
            "e2e_boxes": np.stack(boxes).astype(np.int32),
            "e2e_ok": np.stack(ok).astype(bool)}


def jax_reference(cases, tiers) -> dict:
    """Every stored result (module doc) but the cases and tiers."""
    segs, scales = segmenters(cases, tiers)
    out = {"int8_scales": scales}
    for route in ROUTES:
        for k, v in jax_route(segs[route], cases, tiers).items():
            out[f"{route}_{k}"] = v
        print(route, json.loads(str(out[f"{route}_summary"])), flush=True)
    out.update(jax_e2e(segs["w16_bf16"], cases, tiers))
    return out


def main():
    sys.path.insert(0, ROOT)
    from twinvoice_tpu_torch.eval.gauntlet import GauntletCase, save_cases

    cases, tiers = render_cases()
    ref = jax_reference(cases, tiers)
    port_cases = [GauntletCase(c.image, c.mask, c.invoice_no, c.date, c.amount,
                               c.level, c.font) for c in cases]
    save_cases(OUT, port_cases, tiers=tiers, **ref)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
    print("e2e", str(ref["e2e_summary"]))


if __name__ == "__main__":
    main()
