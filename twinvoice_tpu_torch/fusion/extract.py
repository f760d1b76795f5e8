"""The field-fusion pipeline: the port of ``twinvoice_tpu.fusion.extract``
(reference ``extract_invoice_meta``, app_camera.py:736-878).

Flow, in the JAX package's order:

1. optional auto-rotate of landscape photos by QR position
2. QR scan → header parse (invoice_no + ROC date) + TEXT-QR line items
3. U-Net segmentation → per-field crops (always runs: amount needs OCR)
4. each configured OCR engine reads the 3 crops (mode "invoice", "date",
   "amount")
5. merge with priority **QR > engines in configured order** and regex
   re-validation; provenance recorded per field (source/date_source/
   amount_source); a full-page read when the crops gave no invoice number
   or date (``extract`` only)
6. amount always comes from merged OCR
7. optional items-to-total reconciliation

Pages are uint8 RGB ndarrays (H, W, 3); a PIL image is converted to one on
entry. One code path runs on the CPU and on the card. The JAX extractor
reads each step through a different gray, and so does this one: the
segmenter and the QR scan through OpenCV's luma (``ops.host_image``), the
native decoder through its own float luma. The JAX extractor hands the OCR
engines PIL crops, and each engine makes its own gray of one (Pillow's
``convert("L")`` in the recognizer, OpenCV's luma of ``convert("RGB")`` in
the network engines); this one hands them each crop as
:class:`~twinvoice_tpu_torch.ops.host_image.PilPixels`, which converts as
the PIL crop does, so every engine reads the bytes its JAX counterpart
reads. The full-page fallback reads the page's Pillow luma.

Results are memoized by image content hash on the extractor instance.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from twinvoice_tpu_torch import FIELDS
from twinvoice_tpu_torch.config import FusionConfig
from twinvoice_tpu_torch.fusion.amount import extract_amount
from twinvoice_tpu_torch.fusion.items import adjust_items_to_total
from twinvoice_tpu_torch.ops.host_image import PilPixels, pil_luma
from twinvoice_tpu_torch.qr.detect import detect_qr_regions
from twinvoice_tpu_torch.qr.parse import parse_header_qr, parse_items_qr
from twinvoice_tpu_torch.utils.errors import FailureLog
from twinvoice_tpu_torch.utils.tracing import trace_span

_INVOICE_NO_RE = re.compile(r"[A-Z]{2}\d{8}")
_OCR_DATE_RE = re.compile(r"(20\d{2})[/-](\d{2})[/-](\d{1,2})")

# per-field OCR modes: rigid-format fields advertise their format so engines
# can constrain decoding; engines that only distinguish amount-vs-text treat
# anything != "amount" as text
_FIELD_MODES = {"invoice_no": "invoice", "date": "date",
                "total_amount": "amount"}


def empty_meta() -> dict:
    return {
        "invoice_no": None,
        "date": None,
        "total_amount": None,
        "source": "unknown",
        "date_source": "unknown",
        "amount_source": "unknown",
        "qr_raw": [],
        "failures": [],
    }


# a structured alias for typing call sites; the pipeline returns the plain
# dict of empty_meta()
@dataclass
class InvoiceMeta:
    invoice_no: Optional[str] = None
    date: Optional[str] = None
    total_amount: Optional[str] = None
    source: str = "unknown"
    date_source: str = "unknown"
    amount_source: str = "unknown"
    qr_raw: List[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "InvoiceMeta":
        return cls(**{k: d.get(k, v) for k, v in cls().__dict__.items()})


def as_page(image) -> np.ndarray:
    """A PIL image (converted to RGB) or a uint8 (H, W, 3) array → the page
    as a uint8 RGB array; raises on any other array."""
    page = np.asarray(image.convert("RGB") if hasattr(image, "convert") else image)
    if page.dtype != np.uint8 or page.ndim != 3 or page.shape[2] != 3:
        raise ValueError(f"a page is a uint8 (H, W, 3) RGB array, got {page.dtype} "
                         f"{page.shape}")
    return page


def image_content_key(page: np.ndarray) -> str:
    """The md5 of the page's pixel bytes: the JAX key of the same page as an
    RGB PIL image (``tobytes()``)."""
    return hashlib.md5(np.ascontiguousarray(page).tobytes()).hexdigest()


def clean_invoice_candidate(text: str) -> Optional[str]:
    """Uppercase, strip non-alphanumerics, then find AA######## inside."""
    cleaned = re.sub(r"[^A-Za-z0-9]", "", text.upper())
    m = _INVOICE_NO_RE.search(cleaned)
    return m.group(0) if m else None


def clean_date_candidate(text: str) -> Optional[str]:
    """Find a western yyyy-mm-dd / yyyy/mm/d date inside OCR noise."""
    cleaned = re.sub(r"[^0-9/:-]", "", text)
    m = _OCR_DATE_RE.search(cleaned)
    if not m:
        return None
    y, mm, dd = m.groups()
    return f"{y}-{mm}-{dd.zfill(2)}"


def auto_rotate_by_qr(page: np.ndarray, qr_regions_fn=None) -> np.ndarray:
    """Rotate a landscape page upright using the QR's horizontal position
    (the QR sits at the bottom of a TW invoice): a quarter turn
    anticlockwise when it lies left of 40% of the width, clockwise right of
    60% (Pillow's ``rotate(±90, expand=True)``). Never rotates when no QR is
    found or the page is already portrait. ``qr_regions_fn`` (page → boxes)
    defaults to ``qr.detect.detect_qr_regions``, the port's numpy locator."""
    h, w = page.shape[:2]
    if w <= h:
        return page
    regions = (qr_regions_fn or detect_qr_regions)(page)
    if not regions:
        return page
    x1, _, x2, _ = regions[0]
    cx = (x1 + x2) / 2
    if cx < w * 0.4:
        return np.ascontiguousarray(np.rot90(page, 1))
    if cx > w * 0.6:
        return np.ascontiguousarray(np.rot90(page, -1))
    return page


def _engine_crop(crop):
    """An RGB crop → :class:`PilPixels` of it (what the JAX extractor hands
    its engines: the PIL crop); a gray crop or None passes through."""
    if crop is None or crop.ndim == 2:
        return crop
    return PilPixels(crop)


class InvoiceExtractor:
    """Binds the segmenter, QR pipeline and OCR engines into one callable.

    ``segmenter`` exposes ``segment_array`` (and, for the bulk route,
    ``segment_array_batch``), as ``infer.pipeline.Segmenter`` does.
    ``engines``: OCR engines in *priority order below QR*.
    """

    def __init__(
        self,
        segmenter,
        qr_pipeline=None,
        engines: Sequence = (),
        cfg: FusionConfig = FusionConfig(),
    ):
        self.segmenter = segmenter
        self.qr = qr_pipeline
        self.engines = list(engines)
        self.cfg = cfg
        self._cache: Dict[str, Tuple[dict, list, list]] = {}

    def clear_cache(self):
        self._cache.clear()

    def extract(self, image, qr_img=None) -> Tuple[dict, list, list]:
        """Returns (meta dict, items list, raw QR payloads)."""
        page = as_page(image)
        key = image_content_key(page)
        if key in self._cache:
            return self._cache[key]

        meta = empty_meta()
        log = FailureLog()

        if self.cfg.auto_rotate:
            with trace_span("fusion.autorotate"):
                page = log.guarded("qr", auto_rotate_by_qr, page, default=page)

        # -- QR ------------------------------------------------------------
        qr_raw: List[str] = []
        if self.cfg.use_qr and self.qr is not None:
            with trace_span("fusion.qr_scan"):
                qr_raw = log.guarded("qr", self.qr.scan,
                                     qr_img if qr_img is not None else page, default=[])
        meta["qr_raw"] = qr_raw
        qr_invoice, qr_date = parse_header_qr(qr_raw)
        items = parse_items_qr(qr_raw)
        if qr_invoice:
            meta["invoice_no"] = qr_invoice
            meta["source"] = "QR"
        if qr_date:
            meta["date"] = qr_date
            meta["date_source"] = "QR"

        # -- segmentation (always: amount requires OCR on its crop) --------
        with trace_span("fusion.segment"):
            _, crops = log.guarded(
                "segment", self.segmenter.segment_array, page, default=({}, {})
            )

        # -- OCR engines over the 3 field crops ----------------------------
        # readings[field] = [engine0_text, engine1_text, ...] in priority order
        readings: Dict[str, List[str]] = {f: [] for f in FIELDS}
        field_crops = [_engine_crop(crops.get(f)) for f in FIELDS]
        modes = [_FIELD_MODES[f] for f in FIELDS]
        with trace_span("fusion.ocr"):
            for engine in self.engines:
                if hasattr(engine, "read_batch"):
                    # one device call for all three field crops
                    results = log.guarded(
                        "ocr", engine.read_batch, field_crops, modes=modes,
                        default=[None] * len(FIELDS),
                    )
                    for fieldname, r in zip(FIELDS, results):
                        readings[fieldname].append(r.text if r else "")
                    continue
                for fieldname, crop, mode in zip(FIELDS, field_crops, modes):
                    if crop is None:
                        readings[fieldname].append("")
                        continue
                    result = log.guarded("ocr", engine.read, crop, mode=mode)
                    readings[fieldname].append(result.text if result else "")

        # -- merge: invoice number (QR already won if present) -------------
        if not meta["invoice_no"]:
            for text in readings["invoice_no"]:
                cand = clean_invoice_candidate(text) if text else None
                if cand:
                    meta["invoice_no"] = cand
                    meta["source"] = "merged_ocr"
                    break

        # -- merge: date ---------------------------------------------------
        if not meta["date"]:
            for text in readings["date"]:
                cand = clean_date_candidate(text) if text else None
                if cand:
                    meta["date"] = cand
                    meta["date_source"] = "merged_ocr"
                    break

        # -- full-page fallback: when the crops yielded nothing, detect text
        # lines over the whole page and regex the candidates
        if self.cfg.full_page_fallback and (
            not meta["invoice_no"] or not meta["date"]
        ):
            eng = next(
                (e for e in self.engines
                 if getattr(e, "name", "") == "torchocr" and e.available()),
                None,
            )
            if eng is not None:
                from twinvoice_tpu_torch.ocr.torchocr.detector import read_page

                with trace_span("fusion.full_page"):
                    lines = log.guarded("ocr", read_page, pil_luma(page), eng,
                                        default=[])
                texts = [r.text for _, r in lines]
                if not meta["invoice_no"]:
                    for t in texts:
                        cand = clean_invoice_candidate(t)
                        if cand:
                            meta["invoice_no"] = cand
                            meta["source"] = "full_page_ocr"
                            break
                if not meta["date"]:
                    for t in texts:
                        cand = clean_date_candidate(t)
                        if cand:
                            meta["date"] = cand
                            meta["date_source"] = "full_page_ocr"
                            break

        # -- amount: always merged OCR ------------------------------------
        meta["total_amount"] = extract_amount(*readings["total_amount"])
        meta["amount_source"] = "merged_ocr"

        # -- reconcile items to the recognized total -----------------------
        if self.cfg.adjust_items_to_total and items:
            try:
                total = int(meta["total_amount"])
            except (TypeError, ValueError):
                total = 0
            if total > 0:
                items = adjust_items_to_total(items, total)

        meta["failures"] = log.as_dicts()
        result = (meta, items, qr_raw)
        self._cache[key] = result
        return result

    # -- bulk path -----------------------------------------------------------

    def extract_batch(self, images) -> List[Tuple[dict, list, list]]:
        """Process many invoices with batched device work: one segmenter
        call for all pages (when it exposes ``segment_array_batch``) and one
        recognizer call for all field crops (``read_batch``). QR decoding
        and crop slicing stay per page on the host, the QR scans in a thread
        pool under the segmenter's call. No full-page fallback, and
        ``read_batch`` is not guarded, as in the JAX package. Results are
        cache-coherent with :meth:`extract`.
        """
        pages = [as_page(im) for im in images]
        keys = [image_content_key(p) for p in pages]
        results: List = [None] * len(pages)
        todo = []
        for i, key in enumerate(keys):
            if key in self._cache:
                results[i] = self._cache[key]
            else:
                todo.append(i)
        if not todo:
            return results

        imgs = [pages[i] for i in todo]
        logs = [FailureLog() for _ in todo]
        if self.cfg.auto_rotate:
            imgs = [
                log.guarded("qr", auto_rotate_by_qr, im, default=im)
                for im, log in zip(imgs, logs)
            ]

        # 1+2. QR scans run in a thread pool overlapped with the batched
        # segmenter call: the native decoder (ctypes) releases the GIL
        scan_qr = self.cfg.use_qr and self.qr is not None
        pool = None
        qr_futs = None
        if scan_qr and self.cfg.host_workers > 1 and len(imgs) > 1:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=self.cfg.host_workers)
            with trace_span("fusion.qr_scan_submit"):
                qr_futs = [
                    pool.submit(log.guarded, "qr", self.qr.scan, im, default=[])
                    for im, log in zip(imgs, logs)
                ]

        try:
            with trace_span("fusion.segment"):
                if hasattr(self.segmenter, "segment_array_batch"):
                    # box-only: extraction reads only the crops; gray_h2d
                    # uploads luminance (3× fewer bytes up)
                    kw = {}
                    if getattr(self.cfg, "gray_h2d", False):
                        kw["gray_h2d"] = True
                    if getattr(self.cfg, "h2d_chunks", 1) > 1:
                        kw["h2d_chunks"] = self.cfg.h2d_chunks
                    all_crops = [
                        c for _, c in self.segmenter.segment_array_batch(
                            imgs, return_masks=False, **kw)
                    ]
                else:
                    all_crops = []
                    for im, log in zip(imgs, logs):
                        _, crops = log.guarded(
                            "segment", self.segmenter.segment_array, im,
                            default=({}, {})
                        )
                        all_crops.append(crops)

            with trace_span("fusion.qr_scan"):
                if qr_futs is not None:
                    qr_raws = [f.result() for f in qr_futs]
                elif scan_qr:
                    qr_raws = [
                        log.guarded("qr", self.qr.scan, im, default=[])
                        for im, log in zip(imgs, logs)
                    ]
                else:
                    qr_raws = [[] for _ in imgs]
        finally:
            if pool is not None:
                pool.shutdown(wait=False)

        # 3. OCR: one read_batch per engine over every (invoice, field) crop
        n_fields = len(FIELDS)
        flat_crops = [
            _engine_crop(crops.get(f)) for crops in all_crops for f in FIELDS
        ]
        modes = [_FIELD_MODES[f] for _ in all_crops for f in FIELDS]
        per_engine_texts = []
        with trace_span("fusion.ocr"):
            for engine in self.engines:
                if hasattr(engine, "read_batch"):
                    outs = engine.read_batch(flat_crops, modes=modes)
                    per_engine_texts.append([o.text if o else "" for o in outs])
                else:
                    texts = []
                    for crop, mode in zip(flat_crops, modes):
                        texts.append(
                            engine.read(crop, mode=mode).text if crop is not None else ""
                        )
                    per_engine_texts.append(texts)

        # 4. merge per invoice (same rules as extract())
        for j, idx in enumerate(todo):
            meta = empty_meta()
            qr_raw = qr_raws[j]
            meta["qr_raw"] = qr_raw
            qr_invoice, qr_date = parse_header_qr(qr_raw)
            items = parse_items_qr(qr_raw)
            if qr_invoice:
                meta["invoice_no"], meta["source"] = qr_invoice, "QR"
            if qr_date:
                meta["date"], meta["date_source"] = qr_date, "QR"

            readings = {
                f: [texts[j * n_fields + fi] for texts in per_engine_texts]
                for fi, f in enumerate(FIELDS)
            }
            if not meta["invoice_no"]:
                for text in readings["invoice_no"]:
                    cand = clean_invoice_candidate(text) if text else None
                    if cand:
                        meta["invoice_no"], meta["source"] = cand, "merged_ocr"
                        break
            if not meta["date"]:
                for text in readings["date"]:
                    cand = clean_date_candidate(text) if text else None
                    if cand:
                        meta["date"], meta["date_source"] = cand, "merged_ocr"
                        break
            meta["total_amount"] = extract_amount(*readings["total_amount"])
            meta["amount_source"] = "merged_ocr"
            if self.cfg.adjust_items_to_total and items:
                try:
                    total = int(meta["total_amount"])
                except (TypeError, ValueError):
                    total = 0
                if total > 0:
                    items = adjust_items_to_total(items, total)
            meta["failures"] = logs[j].as_dicts()
            result = (meta, items, qr_raw)
            self._cache[keys[idx]] = result
            results[idx] = result
        return results
