"""The OCR engine of the CTC recognizer: the port of
``twinvoice_tpu/ocr/jaxocr/engine.py``.

The model loads once onto its device; a batch of crops is one device call
(the CRNN, the log-softmax, the argmax, the confidence and the top-8
posteriors), and the CTC decoders run on the host. Crops are normalized the
way training data is rendered: grayscale, height-fit to 28 px inside a
32×256 row. The host steps OpenCV does in the JAX engine are
``ops.host_image``'s numpy, exact to it.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch

from twinvoice_tpu_torch import resolve_device
from twinvoice_tpu_torch.ocr.base import OcrResult
from twinvoice_tpu_torch.ocr.torchocr.charset import (
    DEFAULT,
    FIELD_PATTERNS,
    Charset,
    beam_ctc_decode,
    constrained_ctc_decode,
)
from twinvoice_tpu_torch.ocr.torchocr.lm import default_lm
from twinvoice_tpu_torch.ocr.torchocr.model import (
    DEFAULT_WEIGHTS_PATH,
    IMG_H,
    IMG_W,
    crnn_apply,
    load_crnn_weights,
)
from twinvoice_tpu_torch.models.unet import _tree_map
from twinvoice_tpu_torch.ops.host_image import (
    erode2x2,
    gaussian_blur3,
    otsu_threshold,
    resize_linear_u8,
    rgb_to_gray,
)

TOP_K = 8


def to_gray(image) -> np.ndarray:
    """PIL image (its own ``convert("L")``) or uint8 ndarray, RGB or gray →
    uint8 (H, W)."""
    arr = np.asarray(image.convert("L") if hasattr(image, "convert") else image)
    if arr.ndim == 3:
        arr = rgb_to_gray(arr)
    return arr


def posteriors(logits):
    """CTC logits (B, T, classes) → ``(ids, conf, tk_ids, tk_lp, blank_lp)``:
    the per-frame argmax of the logits (ties to the first index), the mean
    top-1 probability over non-blank frames (the divisor clamped at 1), the
    top-8 ids and log-probs of the float32 log-softmax (a stable descending
    sort, so ties go to the lowest index, as ``lax.top_k``'s do) and the
    blank's log-prob."""
    logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    probs = torch.exp(logp)
    ids = torch.argmax(logits, dim=-1)
    top = torch.amax(probs, dim=-1)
    nonblank = ids != 0
    conf = torch.sum(top * nonblank, dim=-1) / torch.clamp(
        torch.sum(nonblank, dim=-1), min=1)
    tk_lp, tk_ids = torch.sort(logp, dim=-1, descending=True, stable=True)
    return ids, conf, tk_ids[..., :TOP_K], tk_lp[..., :TOP_K], logp[..., 0]


def infer_rows(params, state, x, *, arch: str = "t32"):
    """The device half of a batch: prepared rows ``x`` (B, 1, 32, 256)
    float32 → :func:`posteriors` of the CRNN's logits, on ``x``'s device.
    Call it with TF32 off (``torch.backends.cudnn.flags(enabled=True,
    allow_tf32=False)``)."""
    return posteriors(crnn_apply(params, state, x, arch=arch)[0])


def prepare_crop(image) -> Optional[np.ndarray]:
    """PIL/ndarray crop → (IMG_H, IMG_W) float32 [0,1], or None if unusable.

    Robustness normalizations (photographic crops):
    - contrast stretch (2nd-98th percentile → full range), so low-contrast /
      shadowed photos land in the training distribution
    - polarity normalization: if the Otsu-dark side is the majority the crop
      is inverted video (light text on dark) — flip it so ink is dark, which
      is the only polarity the renderer produces
    - tight ink crop (Otsu) before height-normalizing, matching the training
      renderer's tight glyph bbox — without this, the margin around a U-Net
      crop shrinks the glyphs and CTC starts collapsing repeated digits.
    """
    arr = to_gray(image)
    if arr.size == 0:
        return None
    lo, hi = np.percentile(arr, (2, 98))
    if hi - lo > 4:  # stretch unless the crop is essentially flat
        arr = np.clip((arr.astype(np.float32) - lo) * (255.0 / (hi - lo)), 0, 255)
        arr = arr.astype(np.uint8)
    thr, binary = otsu_threshold(arr)
    if (binary == 0).mean() > 0.5:  # dark majority → inverted video
        arr = 255 - arr
        binary = 255 - binary
    ys, xs = np.where(binary == 0)  # ink = dark
    if len(xs) > 4:  # tight content box with a 2px pad
        y0 = max(0, ys.min() - 2)
        y1 = min(arr.shape[0], ys.max() + 3)
        x0 = max(0, xs.min() - 2)
        x1 = min(arr.shape[1], xs.max() + 3)
        arr = arr[y0:y1, x0:x1]
    h, w = arr.shape
    scale = (IMG_H - 4) / max(h, 1)
    new_w = max(1, min(IMG_W, int(w * scale)))
    arr = resize_linear_u8(arr, new_w, IMG_H - 4)
    out = np.full((IMG_H, IMG_W), 255, np.float32)
    out[2 : IMG_H - 2, :new_w] = arr
    return out / 255.0


def _group_into_bands(boxes):
    """Group detector boxes into vertical bands of y-overlapping boxes.

    Boxes whose vertical extents overlap by >50% of the smaller height are
    the same text line (words of one line); bands are returned top-to-bottom
    as merged (x1, y1, x2, y2) extents."""
    if not boxes:
        return []
    bands = []  # each: [x1, y1, x2, y2]
    for (x1, y1, x2, y2) in sorted(boxes, key=lambda b: b[1]):
        placed = False
        for band in bands:
            overlap = min(y2, band[3]) - max(y1, band[1])
            if overlap > 0.5 * min(y2 - y1, band[3] - band[1]):
                band[0] = min(band[0], x1)
                band[1] = min(band[1], y1)
                band[2] = max(band[2], x2)
                band[3] = max(band[3], y2)
                placed = True
                break
        if not placed:
            bands.append([x1, y1, x2, y2])
    return [tuple(b) for b in sorted(bands, key=lambda b: b[1])]


class TorchOcrEngine:
    name = "torchocr"

    # a line is "certain" when every frame's top-1 beats its top-2 by at
    # least this many nats — then every surviving CTC path agrees with the
    # argmax path and beam search cannot change the decode
    CASCADE_MARGIN = 3.0

    def __init__(self, weights_dir: Optional[str] = None, params=None, state=None,
                 charset: Charset = DEFAULT, arch: str = "t32",
                 decode: str = "cascade", device=None):
        """``decode``: decode policy for text lines.

        - "greedy": per-frame argmax (cheapest)
        - "beam_lm": CTC prefix beam search fused with the bundled domain
          char-LM (charset.beam_ctc_decode + lm.default_lm) on every line
        - "cascade" (default): greedy, escalating to beam_lm only on
          UNCERTAIN lines — any frame whose top-2 posterior is within
          CASCADE_MARGIN nats of its top-1. Confident lines decode at
          greedy cost; degraded lines get the full beam.

        ``params``/``state``: the port's trees (``model.crnn_params_from_jax``);
        by default the weights are read from ``weights_dir`` (the bundled
        recognizer when None), with their charset and arch. A file that
        cannot be read leaves the engine unavailable (``available()`` is
        False), as in the JAX engine. ``device=None`` means ``"cuda"``.
        """
        self.device = resolve_device(device)
        self.charset = charset
        self.arch = arch
        assert decode in ("greedy", "beam_lm", "cascade"), decode
        self.decode = decode
        self._lm = None
        if params is None:
            wd = weights_dir or DEFAULT_WEIGHTS_PATH
            try:
                params, state, self.charset, self.arch = load_crnn_weights(wd)
            except Exception:
                params = state = None
        if params is not None:
            params, state = (_tree_map(lambda t: t.to(self.device), tree)
                             for tree in (params, state))
        self._params = params
        self._state = state

    def _infer(self, rows):
        """Prepared rows, a list of (32, 256) float32 arrays → the device
        half's five outputs (:func:`infer_rows`) as numpy arrays, in one
        device call."""
        x = torch.from_numpy(np.stack(rows).astype(np.float32, copy=False))
        with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True,
                                                                allow_tf32=False):
            out = infer_rows(self._params, self._state,
                             x.to(self.device)[:, None], arch=self.arch)
        return tuple(t.cpu().numpy() for t in out)

    def available(self) -> bool:
        return self._params is not None

    def _decode_row(self, k, ids, tk_ids, tk_lp, blank_lp) -> str:
        """Decode batch row ``k`` per the engine's decode policy."""
        use_beam = self.decode == "beam_lm"
        if self.decode == "cascade":
            # escalate only when some frame is ambiguous (top-2 within
            # CASCADE_MARGIN nats of top-1) — otherwise beam == greedy
            margin = float(np.min(tk_lp[k, :, 0] - tk_lp[k, :, 1]))
            use_beam = margin < self.CASCADE_MARGIN
        if use_beam:
            if self._lm is None:
                self._lm = default_lm()
            text, _ = beam_ctc_decode(self.charset, tk_ids[k], tk_lp[k],
                                      blank_lp[k], lm=self._lm)
            return text
        return self.charset.greedy_ctc_decode(ids[k])

    def read(self, image, mode: str = "text") -> OcrResult:
        return self.read_batch([image], modes=[mode])[0]

    def _split_lines(self, image):
        """A U-Net field crop can cover several text lines (a loose box —
        the tall-crop failure mode the e2e gauntlet surfaced); the CTC
        recognizer is single-line, so split multi-line crops with the text
        detector and read each line. Returns a list of line sub-crops
        (top-to-bottom), or [whole crop] when ≤1 line is found.

        Detected boxes are grouped into vertical BANDS by y-overlap before
        deciding to split: on a high-resolution photo a single
        text line is routinely taller than the old 2*IMG_H gate, and its
        widely spaced words come back as separate detector boxes — splitting
        those and rejoining permutes/truncates the read. One band ⟹ one
        line ⟹ no split, regardless of pixel height."""
        from twinvoice_tpu_torch.ocr.torchocr.detector import detect_lines

        arr = to_gray(image)
        if arr.shape[0] < 2 * IMG_H:  # short crop: assuredly one line
            return [arr]
        # field crops: the classical map is crisp on print and cheap;
        # the learned/hybrid head is a PAGE-level detector (trained on
        # full pages — see detect_lines' A/B)
        boxes = detect_lines(arr, method="classical", device=self.device)
        bands = _group_into_bands(boxes)
        if len(bands) >= 2:
            return [arr[y1:y2, x1:x2] for (x1, y1, x2, y2) in bands]
        # ≤1 band (blur can merge two lines into one detector blob) — fall
        # back to the horizontal ink-projection profile: split at low-ink
        # valleys. A genuinely single tall line has no interior quiet rows,
        # so it comes back as one band → whole crop.
        _, binary = otsu_threshold(arr)
        ink = (binary == 0).mean(axis=1)
        quiet = ink < max(0.02, 0.15 * float(ink.max()))
        bands, start = [], None
        for y, q in enumerate(quiet):
            if not q and start is None:
                start = y
            elif q and start is not None:
                if y - start >= 8:
                    bands.append((max(0, start - 2), min(arr.shape[0], y + 2)))
                start = None
        if start is not None and arr.shape[0] - start >= 8:
            bands.append((max(0, start - 2), arr.shape[0]))
        if len(bands) < 2:
            return [arr]
        return [arr[y0:y1] for (y0, y1) in bands]

    def read_batch(self, images, modes=None) -> list:
        """Batched variant: one device call for the recognizer across all
        crops AND all detected lines within multi-line crops (the fusion
        pipeline reads 3 field crops per invoice)."""
        if not self.available():
            return [OcrResult("", self.name) for _ in images]
        modes = modes or ["text"] * len(images)
        # per image: the list of prepared line sub-crops; for split crops
        # the prepared WHOLE crop rides along as one extra batch row so the
        # split read can be rejected when the unsplit read is more confident
        # (a wrongly split single line reads worse than the whole)
        parts, wholes = [], []
        variants = []  # per image: prepared test-time variant rows
        for im, mode in zip(images, modes):
            if im is None:
                parts.append([])
                wholes.append(None)
                variants.append([])
                continue
            lines = self._split_lines(im)
            prepped = [prepare_crop(ln) for ln in lines]
            parts.append([p for p in prepped if p is not None])
            wholes.append(prepare_crop(im) if len(lines) > 1 else None)
            # test-time multi-crop voting: single-line
            # amount crops additionally read under two cheap source
            # transforms (bolder ink, slight x-stretch); a 2-of-3 digit
            # vote beats a single greedy read on photographic crops.
            # Multi-line amount crops are excluded — their variants would
            # re-read the joined crop, the exact trap the digit-line
            # selection below exists to avoid.
            if mode == "amount" and len(lines) == 1:
                variants.append([v for v in self._amount_variants(im)
                                 if v is not None])
            else:
                variants.append([])

        flat = [p for ps in parts for p in ps]
        flat += [w for w in wholes if w is not None]
        flat += [v for vs in variants for v in vs]
        out = [OcrResult("", self.name) for _ in images]
        if not flat:
            return out
        ids, conf, tk_ids, tk_lp, blank_lp = self._infer(flat)

        k = 0
        amount_line_pick = [False] * len(images)
        chosen_row = [None] * len(images)  # batch row backing out[i]
        for i, ps in enumerate(parts):
            texts, confs, rows = [], [], []
            for _ in ps:
                t = self._decode_row(k, ids, tk_ids, tk_lp, blank_lp)
                if t:
                    texts.append(t)
                    confs.append(float(conf[k]))
                    rows.append(k)
                k += 1
            if not texts:
                continue
            if len(texts) > 1 and modes[i] == "amount":
                # a joined multi-line read would concatenate digits from
                # unrelated lines; keep the line with the most digits —
                # but date-shaped lines are disqualified first (an e2e
                # diagnosis: a date line has 8 digits and outscored the
                # 5-digit amount, so '24195' extracted as '202801')
                def _datey(t):
                    return bool(
                        re.search(r"(19|20)\d{2}[-/.]\d{1,2}[-/.]\d{1,2}", t)
                        or re.fullmatch(r"(19|20)\d{6}", re.sub(r"\D", "", t))
                    )

                digits = [sum(ch.isdigit() for ch in t) for t in texts]
                j = max(range(len(texts)),
                        key=lambda j: (not _datey(texts[j]), digits[j], j))
                out[i] = OcrResult(texts[j], self.name, confidence=confs[j])
                amount_line_pick[i] = True
                chosen_row[i] = rows[j]
            else:
                c = float(np.mean(confs))
                out[i] = OcrResult(" ".join(texts), self.name, confidence=c)
                chosen_row[i] = rows[0] if len(rows) == 1 else None
        # whole-crop fallback rows (appended after all split parts)
        for i, w in enumerate(wholes):
            if w is None:
                continue
            wk = k
            t = self._decode_row(k, ids, tk_ids, tk_lp, blank_lp)
            c = float(conf[k])
            k += 1
            if not t or c <= (out[i].confidence or 0.0):
                continue
            if amount_line_pick[i]:
                # a confident whole-crop read of a multi-line
                # amount crop concatenates digits from unrelated lines —
                # exactly what the digit-line selection above guards
                # against. Only let it override when it passes the same
                # digit-dominance bar as the selected line.
                digits = sum(ch.isdigit() for ch in t)
                if digits < len(t) * 0.8 or digits <= sum(
                    ch.isdigit() for ch in out[i].text
                ):
                    continue
            out[i] = OcrResult(t, self.name, confidence=c)
            chosen_row[i] = wk
        # amount-mode variant rows: 2-of-3 vote among base + variants,
        # plus a format-constrained candidate from the base row
        for i, vs in enumerate(variants):
            if not vs:
                continue
            cands = []
            if out[i].text:
                cands.append((out[i].text, float(out[i].confidence or 0.0)))
            for _ in vs:
                t = self._decode_row(k, ids, tk_ids, tk_lp, blank_lp)
                c = float(conf[k])
                k += 1
                if t:
                    cands.append((t, c))
            base_digits = sum(ch.isdigit() for ch in out[i].text)
            base_num = "".join(ch for ch in out[i].text if ch.isdigit())
            if (not out[i].text or base_digits < len(out[i].text) * 0.6
                    or base_num.startswith("0")):
                # base greedy read wouldn't even qualify for the vote —
                # or reads a leading-zero amount, which the domain forbids
                # (a classic CTC leading-digit deletion: '10335'→'0335') —
                # let the pattern-constrained re-read of the same frames
                # stand in for it (when base is already digit-clean the
                # constrained read would just duplicate it and
                # double-count the base row against the variants)
                cc = self._constrained(chosen_row[i], "amount",
                                       tk_ids, tk_lp, blank_lp)
                if cc is not None:
                    cands.append(cc)
            scores = {}
            for t, c in cands:
                digits = sum(ch.isdigit() for ch in t)
                if digits == 0 or digits < len(t) * 0.6:
                    continue  # non-digit-dominant reads don't get a vote
                if "".join(ch for ch in t if ch.isdigit()).startswith("0"):
                    continue  # leading-zero amounts are domain-invalid
                scores[t] = scores.get(t, 0.0) + c
            if scores:
                best = max(scores, key=lambda t: scores[t])
                if best != out[i].text and scores[best] > float(
                    out[i].confidence or 0.0
                ):
                    out[i] = OcrResult(best, self.name,
                                       confidence=scores[best] / 2.0)
        # format-constrained decode for rigid-format fields: when the
        # greedy read of an invoice-no / date crop doesn't already contain
        # a well-formed value, re-decode the SAME frame posteriors against
        # the field's pattern automaton — a frame where '0' narrowly beats
        # 'O' in a letter slot then still decodes to 'O'.
        for i, mode in enumerate(modes):
            if mode not in ("invoice", "date"):
                continue
            rx = (r"[A-Z]{2}-?\d{8}" if mode == "invoice"
                  else r"\d{4}[-/.]\d{2}[-/.]\d{1,2}")
            if out[i].text and re.search(rx, out[i].text.upper()):
                continue  # greedy read is already well-formed
            cand = None
            cc = self._constrained(chosen_row[i], mode,
                                   tk_ids, tk_lp, blank_lp,
                                   greedy_text=out[i].text)
            if cc is not None:
                cand = (cc[1], cc[0])
            # lazy variant rescue (the dot-print failure mode): bolder
            # ink / slight blur fuse printhead dots into strokes; only
            # runs when the base read is format-invalid, so the clean hot
            # path pays nothing
            resc = self._variant_rescue(images[i], mode, rx)
            if resc is not None and (cand is None or resc > cand):
                cand = resc
            if cand is not None:
                out[i] = OcrResult(cand[1], self.name,
                                   confidence=min(cand[0], 1.0))
        return out

    def _variant_rescue(self, image, mode, rx):
        """Re-read a format-failing rigid-format crop under two source
        transforms at model resolution — morphological bold (erode) and a
        light Gaussian blur. Both fuse dot-matrix printhead dots into
        continuous strokes (measured on the dot tier: blur alone reads
        +3 pts over base; the any-of-3 oracle is +8). Returns
        ``(score, text)`` — score >1 for a direct format-valid read
        (outranks any constrained path), else the constrained decode's
        margin pseudo-confidence — or None."""
        if image is None:
            return None
        base = prepare_crop(image)
        if base is None:
            return None
        u8 = (base * 255.0).astype(np.uint8)
        variants = [erode2x2(u8), gaussian_blur3(u8)]
        x = np.stack(variants).astype(np.float32) / 255.0
        ids, conf, tk_ids, tk_lp, blank_lp = self._infer(list(x))
        best = None
        for r in range(len(variants)):
            t = self._decode_row(r, ids, tk_ids, tk_lp, blank_lp)
            m = re.search(rx, t.upper()) if t else None
            if m:
                cand = (1.0 + float(conf[r]), m.group(0))
            else:
                cc = self._constrained(r, mode, tk_ids, tk_lp, blank_lp,
                                       greedy_text=t)
                cand = (cc[1], cc[0]) if cc is not None else None
            if cand is not None and (best is None or cand > best):
                best = cand
        return best

    # margin (nats) by which a pattern-constrained path may trail the
    # unconstrained greedy path before it is rejected as a fabrication
    # (a garbage crop forced through the automaton scores far below the
    # greedy path; a one-confusion fix scores just below it)
    CONSTRAINED_TAU = 20.0

    # shape-identical letter/digit pairs (dot-matrix print breaks strokes,
    # so these collapse visually): a constrained decode that differs from
    # the greedy read ONLY through this map is a domain reinterpretation
    # of the same glyphs, not a fabrication — accepted past the margin
    _HOMOGLYPH_PAIRS = frozenset(map(frozenset, (
        "O0", "I1", "S5", "B8", "Z2", "G6", "D0", "Q0", "L1", "A4", "T7",
    )))

    @classmethod
    def _homoglyph_equal(cls, a: str, b: str) -> bool:
        a = a.replace(" ", "").replace("-", "").upper()
        b = b.replace(" ", "").replace("-", "").upper()
        if len(a) != len(b):
            return False
        return all(
            x == y or frozenset((x, y)) in cls._HOMOGLYPH_PAIRS
            for x, y in zip(a, b)
        )

    def _constrained(self, row, mode, tk_ids, tk_lp, blank_lp,
                     greedy_text=None):
        """Pattern-constrained decode of batch row ``row``; returns
        (text, pseudo_confidence) or None (no valid path / margin fail).
        ``greedy_text``: the row's unconstrained read — a constrained
        result that is a pure homoglyph reinterpretation of it bypasses
        the margin gate (see _HOMOGLYPH_PAIRS)."""
        if row is None:
            return None
        text, path_lp = constrained_ctc_decode(
            self.charset, tk_ids[row], tk_lp[row], blank_lp[row],
            FIELD_PATTERNS[mode],
        )
        if text is None:
            return None
        greedy_lp = float(tk_lp[row, :, 0].sum())
        if path_lp < greedy_lp - self.CONSTRAINED_TAU:
            if not (greedy_text and self._homoglyph_equal(text, greedy_text)):
                return None
        T = tk_ids.shape[1]
        return text, float(np.exp((path_lp - greedy_lp) / T))

    @staticmethod
    def _amount_variants(image):
        """Two cheap source-level transforms of an amount crop for
        test-time voting: morphologically bolder ink and a slight
        horizontal stretch (the two render-distribution axes the error
        analysis showed dominate digit confusions)."""
        arr = to_gray(image)
        if arr.size == 0:
            return []
        bold = erode2x2(arr)
        h, w = arr.shape
        stretch = resize_linear_u8(arr, max(2, int(w * 1.12)), h)
        return [prepare_crop(bold), prepare_crop(stretch)]
