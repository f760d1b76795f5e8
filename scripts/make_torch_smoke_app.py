"""Make ``tests/data/torch_smoke_app.npz``: the fixture that holds the
PyTorch port's store, app, network OCR engines and OpenCV-free enhancement
against the JAX package's on the card (``chip_smoke.py`` phase 28).

It reads the four RGB pages of ``tests/data/torch_smoke_fusion.npz`` and
runs, with OpenCV's Intel IPP paths off (``cv2.ipp.setUseIPP(False)``: the
port computes OpenCV's own code):

- (a) ``chip_smoke.store_record`` on the JAX package's ``MemoryStore`` and
  ``SupabaseStore`` (on ``chip_smoke.FakeSupabaseClient``, a failing one,
  and none);
- (d) ``chip_smoke.app_flow`` through the JAX app's ``_build_engine()`` and
  ``_build_store()`` with none of the app's environment variables set (the
  bundled w16 at bf16, ``JaxOcrEngine``, the in-memory store): each page's
  fields and category, the stored rows and every dashboard aggregate; and
  the boxes of the app's segmenter as ``extract`` makes them;
- (b) the field crops of that segmenter on each page, and JAX's
  ``enhance_for_ocr`` (text and amount), ``grayscale_for_ocr`` and
  ``enhance_camera`` of each;
- (c) ``chip_smoke.net_record`` of the JAX extractor with
  ``OcrSpaceEngine`` (``chip_smoke.RecordingTransport``) and
  ``EasyOcrEngine`` (``chip_smoke.RecordingReader``) on those crops.

With IPP back on (as JAX runs by default) it counts the bytes of (b)'s
outputs that differ from the IPP-off ones, and stores the count.

Stored:

- ``crop_<page>_<field>`` uint8 RGB crops; ``enh_<kind>_<page>_<field>``
  the outputs (``kind`` text, amount, gray, camera)
- ``app_boxes`` (4, 3, 4) int32, ``app_ok`` (4, 3) bool
- ``store``, ``net``, ``flow``, ``ipp``: JSON strings

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_app.py
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_smoke_app.npz")


def main():
    sys.path.insert(0, ROOT)
    import cv2
    import jax.numpy as jnp
    from PIL import Image

    import chip_smoke as cs
    from twinvoice_tpu import FIELDS
    from twinvoice_tpu.app import dashboard as jdash
    from twinvoice_tpu.app import main as japp
    from twinvoice_tpu.config import FusionConfig
    from twinvoice_tpu.fusion.classify import classify_invoice
    from twinvoice_tpu.fusion.extract import InvoiceExtractor
    from twinvoice_tpu.ocr import enhance
    from twinvoice_tpu.ocr.easyocr_engine import EasyOcrEngine
    from twinvoice_tpu.ocr.ocrspace import OcrSpaceEngine
    from twinvoice_tpu.store.memory import MemoryStore
    from twinvoice_tpu.store.supabase_store import SupabaseStore

    cv2.ipp.setUseIPP(False)
    with np.load(cs.FUSION_FIXTURE) as z:
        pages = z["pages"]
    out = {"store": cs.store_record(MemoryStore, SupabaseStore)}

    flow, ex, _, _ = cs.app_flow(japp._build_engine, japp._build_store, classify_invoice,
                                 jdash, lambda f: f.to_dict("records"), pages,
                                 to_image=Image.fromarray)
    out["flow"] = flow
    seg = ex.segmenter
    size = seg.cfg.img_size
    boxes, ok, crops = [], [], {}
    for i, page in enumerate(pages):
        small = np.asarray(Image.fromarray(page).resize((size, size)), np.uint8)[None]
        _, bx, o = seg._run(seg._serve_params, jnp.asarray(small),
                            jnp.asarray([[page.shape[1], page.shape[0]]], np.int32))
        boxes.append(np.asarray(bx)[0])
        ok.append(np.asarray(o)[0])
        _, pil_crops = seg.segment_pil(Image.fromarray(page))
        for f in FIELDS:
            if pil_crops.get(f) is not None:
                crops[i, f] = np.asarray(pil_crops[f].convert("RGB"))

    arrays = {f"crop_{p}_{f}": c for (p, f), c in crops.items()}
    for (p, f), c in crops.items():
        for kind, v in cs.enhance_outputs(enhance, c).items():
            arrays[f"enh_{kind}_{p}_{f}"] = v

    transport, reader = cs.RecordingTransport(), cs.RecordingReader()
    jex = InvoiceExtractor(cs.CropSegmenter(crops, pages, as_crop=Image.fromarray), None,
                           [OcrSpaceEngine(api_key=cs.APP_KEY, transport=transport),
                            EasyOcrEngine(reader=reader)],
                           cfg=FusionConfig(use_qr=False, auto_rotate=False))
    out["net"] = cs.net_record(lambda p: jex.extract(Image.fromarray(p)), transport, reader,
                               pages)

    cv2.ipp.setUseIPP(True)
    differ = {k: 0 for k in cs.ENHANCE_FNS}
    total = 0
    for (p, f), c in crops.items():
        for kind, v in cs.enhance_outputs(enhance, c).items():
            differ[kind] += int((v != arrays[f"enh_{kind}_{p}_{f}"]).sum())
            total += v.size
    out["ipp"] = {"crops": len(crops), "bytes": total, "differ_with_ipp_on": differ}

    np.savez_compressed(OUT, app_boxes=np.stack(boxes).astype(np.int32),
                        app_ok=np.stack(ok).astype(bool),
                        **{k: np.asarray(json.dumps(v, ensure_ascii=False))
                           for k, v in out.items()}, **arrays)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
    print("ipp", out["ipp"])
    for rec, cat in zip(flow["fields"], flow["categories"]):
        print(rec["meta"]["invoice_no"], rec["meta"]["date"], rec["meta"]["total_amount"], cat,
              rec["items"])
    print("boxes", np.stack(boxes).tolist(), np.stack(ok).tolist())


if __name__ == "__main__":
    main()
