"""Make ``tests/data/torch_smoke_qr.npz``: the fixture that holds the PyTorch
port's QR locator, QR scan, auto-rotate, QR encoder and labelme core against
the JAX package (``chip_smoke.py`` phase 27, ``tests/test_torch_fixture_qr.py``).

The QR pages, rendered by the JAX package (``render_invoice(seed, layout_jitter
=0.5)``, seeds 0 and 5) and changed with OpenCV and Pillow:

- ``s{seed}_rot90`` / ``_rot-90``: the page turned a quarter each way (the
  landscape pages of auto-rotate);
- ``s{seed}_x0.45`` / ``_x0.5``: INTER_AREA downscales (288×198, 320×220),
  under the 420 px of the scan's first pass; at 0.45× the region pass
  decides JAX's result (one payload, where the scan without it reads two);
- ``s0_x0.55``: a 0.55× downscale where cv2's detector finds no code and
  JAX's scan reads one payload;
- ``s0_persp`` (a perspective warp), ``s5_soft`` (0.5× down and back up,
  INTER_LINEAR), ``s0_r7`` (a 7° turn, bilinear, white fill), ``s5_lowc``
  (contrast ×0.3 + 150);
- ``blank``: 440×640 of paper grey, no code.

OpenCV's locator draws from its per-thread generator (``theRNG()``, which
k-means++ seeds from), so every JAX call that runs it is preceded by
``cv2.setRNGSeed(0)``; the port's checks call ``qr.locate.set_rng_seed(0)``
before theirs.

Stored (JSON strings hold the lists):

- ``names``; ``page_<i>`` uint8 RGB, or for a landscape page ``turned_<i>``
  = (seed, k): ``np.rot90(portrait_<seed>, k)``, which is Pillow's
  ``rotate(90·k, expand=True)`` exactly; ``portrait_<seed>`` the rendered
  page;
- ``truth``: each page's true payloads;
- ``cv2_boxes``: the JAX package's ``detect_qr_regions`` (``cv2.QRCodeDetector``);
- ``cv2_quads``: for each page, the JAX scan's locator calls on its gray
  (``detectMulti``, then ``detect`` where it fails): ``[found, quads]``, the
  float32 quads (n, 4, 2) as lists;
- ``sweep_quads`` and ``sweep_native``: the same, and the native-decoder
  scan, on the sweep's 82 pages, keyed ``"<seed>_<scale>"``: the INTER_AREA
  downscales of ``portrait_<seed>`` at ``SWEEP_SCALES`` (rebuilt from the
  portrait pages where they are checked, not stored);
- ``jax_native``: ``QrPipeline(decoders=[native_decode]).scan``;
  ``jax_default``: ``QrPipeline().scan`` (native, then cv2's decoder);
  ``jax_noregion``: the native scan with ``detect_qr_regions`` returning no
  box, which marks the pages where the region pass decides the result;
- ``jax_turn``: for each landscape page, ``np.rot90``'s ``k`` of JAX's
  ``auto_rotate_by_qr`` (1: ``rotate(90)``, −1: ``rotate(-90)``, 0: none);
- ``extract_pages`` (indices: the landscape and 0.45× pages), ``jax_extract``
  (``chip_smoke.fusion_record`` of JAX's ``InvoiceExtractor.extract``: the
  bundled w16 at fp32, ``QrPipeline()``, ``JaxOcrEngine()``, the default
  ``FusionConfig``, auto-rotate on), ``extract_boxes`` (n, 3, 4) int32 and
  ``extract_ok`` (n, 3) bool: JAX's ``segment_pil`` boxes on the page
  ``extract`` segments (the turned one);
- ``enhance_in_<i>`` / ``enhance_out_<i>``, i < 3: region crops and
  ``enhance_qr_region`` of them by OpenCV's own code (``cv2.ipp.setUseIPP(
  False)``: with Intel IPP on, the wheel's default, OpenCV routes INTER_CUBIC
  to IPP, whose float sums round some exact .5 ties the other way; the
  script prints how many bytes that moves);
- ``encode``: ~40 ``encode_qr_matrix`` cases (payload, level, mask, version
  or null, side, the matrix as ``np.packbits`` hex);
- ``lm_json``, ``lm_mask`` (``rasterize_labelme`` of the JSON's shapes on
  ``portrait_5``, the JSON's nominal size twice the image's), ``lm_img_r``
  and ``lm_mask_r``: ``build_one``'s resizes to 192×256 (INTER_LINEAR of the
  image, INTER_NEAREST of the mask: the ``.npy`` it writes).

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_qr.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_smoke_qr.npz")
SEEDS = (0, 5)
SWEEP_SCALES = tuple(round(0.40 + 0.01 * i, 2) for i in range(41))
LM_SIZE = (192, 256)  # build_one's train_size (width, height)


def render(seed):
    from twinvoice_tpu.data.synthetic import render_invoice

    img, boxes = render_invoice(seed=seed, layout_jitter=0.5)
    return np.asarray(img.convert("RGB")), boxes


def true_payloads():
    from twinvoice_tpu.data.synthetic import header_qr_payload, items_qr_payload

    return [header_qr_payload("AB12345678", "2025-09-09", 120),
            items_qr_payload([{"name": "синt", "qty": 1, "price": 120}])]


def qr_pages():
    """→ [(name, uint8 RGB page, true payloads)] (module doc)."""
    import cv2
    from PIL import Image

    out = []
    truth = true_payloads()
    for seed in SEEDS:
        p, _ = render(seed)
        im = Image.fromarray(p)
        for k in (1, -1):
            turned = np.asarray(im.rotate(90 * k, expand=True))
            assert np.array_equal(turned, np.rot90(p, k))  # stored as the portrait page
            out.append((f"s{seed}_rot{90 * k}", turned, truth))
        for sc in (0.45, 0.5):
            out.append((f"s{seed}_x{sc}",
                        cv2.resize(p, None, fx=sc, fy=sc, interpolation=cv2.INTER_AREA),
                        truth))
    p0, p5 = render(0)[0], render(5)[0]
    h, w = p0.shape[:2]
    out.append(("s0_x0.55", cv2.resize(p0, None, fx=0.55, fy=0.55,
                                       interpolation=cv2.INTER_AREA), truth))
    src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
    dst = np.float32([[30, 20], [w - 10, 0], [w - 40, h - 10], [0, h]])
    out.append(("s0_persp", cv2.warpPerspective(
        p0, cv2.getPerspectiveTransform(src, dst), (w, h), borderValue=(255, 255, 255)),
        truth))
    small = cv2.resize(p5, None, fx=0.5, fy=0.5, interpolation=cv2.INTER_AREA)
    out.append(("s5_soft", cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR), truth))
    out.append(("s0_r7", np.asarray(Image.fromarray(p0).rotate(
        7, expand=True, fillcolor=(255, 255, 255), resample=Image.BILINEAR)), truth))
    out.append(("s5_lowc", (p5.astype(np.float32) * 0.3 + 150).astype(np.uint8), truth))
    out.append(("blank", np.full((640, 440, 3), 246, np.uint8), []))
    return out


def seeded(fn, *args):
    """``fn(*args)`` after ``cv2.setRNGSeed(0)`` (module doc)."""
    import cv2

    cv2.setRNGSeed(0)
    return fn(*args)


def cv2_quads(rgb):
    """``[found, quads]`` of the JAX scan's locator calls on ``rgb``'s gray
    (``twinvoice_tpu/qr/detect.py:_detect_gray``): ``detectMulti``, then
    ``detect``, from a seeded generator."""
    import cv2

    gray = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
    det = cv2.QRCodeDetector()
    cv2.setRNGSeed(0)
    ok, pts = det.detectMulti(gray)
    if not ok or pts is None:
        ok, pts = det.detect(gray)
        ok = bool(ok) and pts is not None
    quads = np.asarray(pts, np.float32).reshape(-1, 4, 2).tolist() if ok else []
    return [bool(ok), quads]


def scans(pages):
    """The JAX scans of each page (module doc) → dict of lists."""
    import twinvoice_tpu.qr.detect as jdetect

    native = jdetect.QrPipeline(decoders=[jdetect.native_decode])
    default = jdetect.QrPipeline()
    res = {"cv2_boxes": [], "cv2_quads": [], "jax_native": [], "jax_default": [],
           "jax_noregion": []}
    for _, p, _ in pages:
        res["cv2_boxes"].append([list(map(int, b)) for b in seeded(jdetect.detect_qr_regions, p)])
        res["cv2_quads"].append(cv2_quads(p))
        res["jax_native"].append(seeded(native.scan, p))
        res["jax_default"].append(seeded(default.scan, p))
        located = jdetect.detect_qr_regions
        jdetect.detect_qr_regions = lambda rgb: []
        try:
            res["jax_noregion"].append(seeded(native.scan, p))
        finally:
            jdetect.detect_qr_regions = located
    return res


def sweep():
    """The sweep's cv2 quads and JAX native scans (module doc), the pages
    checked equal to the port's ``resize_area_u8`` of the portrait pages."""
    import cv2

    import twinvoice_tpu.qr.detect as jdetect
    from twinvoice_tpu_torch.ops.host_image import resize_area_u8

    native = jdetect.QrPipeline(decoders=[jdetect.native_decode])
    quads, scanned = {}, {}
    for seed in SEEDS:
        p, _ = render(seed)
        for sc in SWEEP_SCALES:
            page = cv2.resize(p, None, fx=sc, fy=sc, interpolation=cv2.INTER_AREA)
            assert np.array_equal(page, resize_area_u8(p, fx=sc, fy=sc)), (seed, sc)
            quads[f"{seed}_{sc}"] = cv2_quads(page)
            scanned[f"{seed}_{sc}"] = seeded(native.scan, page)
    return {"sweep_quads": quads, "sweep_native": scanned}


def turn_of(page, turned):
    """np.rot90's k that takes ``page`` to ``turned`` (0 when unchanged)."""
    for k in (0, 1, -1):
        cand = np.rot90(page, k)
        if cand.shape == turned.shape and np.array_equal(cand, turned):
            return k
    raise AssertionError("auto_rotate_by_qr made something other than a quarter turn")


def turns(pages):
    from PIL import Image

    from twinvoice_tpu.fusion.extract import auto_rotate_by_qr

    return [turn_of(p, np.asarray(seeded(auto_rotate_by_qr, Image.fromarray(p)).convert("RGB")))
            if p.shape[1] > p.shape[0] else 0 for _, p, _ in pages]


def extract_runs(pages, idx, turn):
    """JAX's extract on the pages ``idx``, and its segmenter boxes on the
    page extract segments (the turned one)."""
    import jax.numpy as jnp
    from PIL import Image

    from chip_smoke import fusion_record
    from twinvoice_tpu.config import FusionConfig
    from twinvoice_tpu.fusion.extract import InvoiceExtractor
    from twinvoice_tpu.models.pretrained import load_pretrained_segmenter
    from twinvoice_tpu.ocr.jaxocr.engine import JaxOcrEngine
    from twinvoice_tpu.qr.detect import QrPipeline

    seg = load_pretrained_segmenter(dtype=jnp.float32)
    ex = InvoiceExtractor(seg, QrPipeline(), [JaxOcrEngine()], cfg=FusionConfig())
    size = seg.cfg.img_size
    records, boxes, ok = [], [], []
    for i in idx:
        page = pages[i][1]
        records.append(fusion_record(*seeded(ex.extract, Image.fromarray(page))))
        seen = np.ascontiguousarray(np.rot90(page, turn[i]))
        small = np.asarray(Image.fromarray(seen).resize((size, size)), np.uint8)[None]
        sz = np.asarray([[seen.shape[1], seen.shape[0]]], np.int32)
        _, bx, o = seg._run(seg._serve_params, jnp.asarray(small), jnp.asarray(sz))
        boxes.append(np.asarray(bx)[0])
        ok.append(np.asarray(o)[0])
    return records, np.stack(boxes).astype(np.int32), np.stack(ok).astype(bool)


def enhance_cases(pages, boxes):
    """Three region crops and cv2's enhance_qr_region of them, IPP off."""
    import cv2

    from twinvoice_tpu.qr.detect import enhance_qr_region

    names = [n for n, _, _ in pages]
    # cv2's box on the 0.45× page, the header code's region on the 0.5× page
    # (where cv2 finds none), cv2's box on the low-contrast page
    picks = [("s0_x0.45", boxes[names.index("s0_x0.45")][0]),
             ("s5_x0.5", (18, 236, 84, 302)), ("s5_lowc", boxes[names.index("s5_lowc")][0])]
    out, moved = {}, []
    for j, (name, (x1, y1, x2, y2)) in enumerate(picks):
        i = names.index(name)
        crop = np.ascontiguousarray(pages[i][1][y1:y2, x1:x2])
        cv2.ipp.setUseIPP(True)
        with_ipp = enhance_qr_region(crop)
        cv2.ipp.setUseIPP(False)
        try:
            own = enhance_qr_region(crop)
        finally:
            cv2.ipp.setUseIPP(True)
        out[f"enhance_in_{j}"] = crop
        out[f"enhance_out_{j}"] = own
        moved.append(int((with_ipp != own).sum()))
    print(f"enhance crops: bytes where IPP's INTER_CUBIC differs from OpenCV's own: "
          f"{moved} of {[v.size for k, v in out.items() if k.startswith('enhance_out')]}")
    return out


def encode_cases(pages):
    """40 encoder cases: every level and mask, versions 1-10, 12, 15 and 20
    (7 and up carry version info), the fixture's payloads (the non-ASCII
    TEXT one too)."""
    from twinvoice_tpu.qr.encode import encode_qr_matrix

    truth = true_payloads()
    cases = [(truth[k % 2], lvl, mask, None)
             for k, (lvl, mask) in enumerate((l, m) for l in "LMQH" for m in (0, 3, 5, 7))]
    cases += [(truth[k % 2], lvl, m, None) for lvl in "MH" for k, m in enumerate((1, 2, 4, 6))]
    cases += [("TW-" + "0123456789" * v, "LMQH"[v % 4], v % 8, v) for v in range(1, 11)]
    cases += [("TW-" + "0123456789" * 8, "LH"[v % 2], v % 8, v) for v in (12, 15, 20)]
    cases += [("AB12345678", "H", 2, None), ("**紅茶拿鐵:2:60:火腿吐司:1:45", "Q", 6, None),
              ("Latin-1 café, ñandú", "L", 1, 3)]
    out = []
    for payload, level, mask, version in cases:
        m = encode_qr_matrix(payload, level=level, mask=mask, version=version)
        out.append({"payload": payload, "level": level,
                    "mask": mask, "version": version, "side": int(m.shape[0]),
                    "bits": np.packbits(m.ravel()).tobytes().hex()})
    return out


def labelme_case():
    """One labelme JSON of a rendered page's boxes, its nominal size twice
    the image's; JAX's mask and build_one's resizes."""
    import cv2

    from twinvoice_tpu.data.labelme import build_one, rasterize_labelme
    from twinvoice_tpu.data.synthetic import labelme_shapes

    img, boxes = render(5)
    h, w = img.shape[:2]
    meta = {"imageWidth": 2 * w, "imageHeight": 2 * h,
            "shapes": labelme_shapes({k: tuple(2 * v for v in b) for k, b in boxes.items()})}
    meta["shapes"].append({"label": "date", "points": [[10, 20], [300, 60], [120, 400]]})
    meta["shapes"].append({"label": "unknown", "points": [[0, 0], [50, 0], [50, 50]]})
    mask = rasterize_labelme(meta["shapes"], (h, w), (0.5, 0.5))
    with tempfile.TemporaryDirectory() as tmp:
        jp, ip = os.path.join(tmp, "inv.json"), os.path.join(tmp, "inv.png")
        with open(jp, "w", encoding="utf-8") as f:
            json.dump(meta, f)
        cv2.imwrite(ip, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        build_one(jp, ip, os.path.join(tmp, "i"), os.path.join(tmp, "m"), train_size=LM_SIZE)
        mask_r = np.load(os.path.join(tmp, "m", "inv.npy"))
    img_r = cv2.resize(img, LM_SIZE, interpolation=cv2.INTER_LINEAR)  # as build_one
    return {"lm_json": np.asarray(json.dumps(meta)), "lm_mask": mask, "lm_img_r": img_r,
            "lm_mask_r": mask_r}


def main():
    sys.path.insert(0, ROOT)
    pages = qr_pages()
    res = scans(pages)
    swept = sweep()
    turn = turns(pages)
    names = [n for n, _, _ in pages]
    idx = [i for i, n in enumerate(names) if "rot" in n or "x0.45" in n]
    records, boxes, ok = extract_runs(pages, idx, turn)
    data = {f"portrait_{seed}": render(seed)[0] for seed in SEEDS}
    for i, (name, p, _) in enumerate(pages):
        if "_rot" in name:  # a quarter turn of a portrait page: stored as its k
            data[f"turned_{i}"] = np.asarray([int(name[1]), 1 if name.endswith("rot90") else -1])
        else:
            data[f"page_{i}"] = p
    data.update({k: np.asarray(json.dumps(v, ensure_ascii=False))
                 for k, v in {**res, **swept}.items()})
    data.update(
        names=np.asarray(names), truth=np.asarray(json.dumps([t for _, _, t in pages],
                                                             ensure_ascii=False)),
        jax_turn=np.asarray(turn, np.int32), extract_pages=np.asarray(idx, np.int32),
        jax_extract=np.asarray(json.dumps(records, ensure_ascii=False)),
        extract_boxes=boxes, extract_ok=ok,
        encode=np.asarray(json.dumps(encode_cases(pages), ensure_ascii=False)))
    data.update(enhance_cases(pages, res["cv2_boxes"]))
    data.update(labelme_case())
    np.savez_compressed(OUT, **data)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
    for i, n in enumerate(names):
        print(f"{n}: {pages[i][1].shape[:2]} cv2 {res['cv2_boxes'][i]} native "
              f"{len(res['jax_native'][i])} default {len(res['jax_default'][i])} without "
              f"regions {len(res['jax_noregion'][i])} turn {turn[i]}")
    for i, r in zip(idx, records):
        m = r["meta"]
        print(f"extract {names[i]}: {m['invoice_no']} ({m['source']}) {m['date']} "
              f"{m['total_amount']} items {r['items']} qr {len(r['qr_raw'])}")


if __name__ == "__main__":
    main()
