"""Text-line detection: the port of ``twinvoice_tpu/ocr/jaxocr/detector.py``.

The per-pixel "textness" map runs on the device: the classical map (local
contrast against a 15×15 box mean, then a 3×13 max-dilation) or the learned
head (``textness``). Grouping the map into line boxes is small host work:
connected components (``ops.host_image``) and the JAX package's filters.

``detect_lines`` → boxes; ``read_page`` → [(box, OcrResult)] through the CTC
recognizer.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from twinvoice_tpu_torch import resolve_device
from twinvoice_tpu_torch.ocr.torchocr.engine import to_gray
from twinvoice_tpu_torch.ocr.torchocr.textness import pad_page
from twinvoice_tpu_torch.ops.host_image import connected_components_stats

Box = Tuple[int, int, int, int]  # x1, y1, x2, y2 (pixel, inclusive-exclusive)


def _axis_counts(n: int, half: int, device):
    """Pixels of a ``2·half + 1`` window inside an axis of ``n``, per position."""
    i = torch.arange(n, device=device)
    return (torch.clamp(i + half, max=n - 1) - torch.clamp(i - half, min=0)
            + 1).to(torch.float32)


def _textness_map(gray_u8, win: int = 15, dil_w: int = 13, dil_h: int = 3):
    """uint8 (B, H, W) tensor → bool (B, H, W) dilated ink map, on its device.

    Ink = pixels darker than their local mean by 12 (adaptive threshold);
    then an anisotropic max-dilation bridges inter-character gaps
    horizontally so each text line becomes one connected blob. The window
    sums are sums of integers below 2^24, exact in float32 in any order; the
    mean divides them by the window's pixel count inside the image, as the
    JAX map does."""
    x = gray_u8.to(torch.float32)[:, None]
    half = win // 2
    s = F.avg_pool2d(x, win, stride=1, padding=half, divisor_override=1)
    _, _, h, w = x.shape
    cnt = _axis_counts(h, half, x.device)[:, None] * _axis_counts(w, half, x.device)[None, :]
    local_mean = s / cnt
    ink = (x < (local_mean - 12.0)).to(torch.float32)
    dil = F.max_pool2d(ink, (dil_h, dil_w), stride=1, padding=(dil_h // 2, dil_w // 2))
    return dil[:, 0] > 0


_learned_numpy = "unset"
_learned_on = {}


def _learned(device):
    """The bundled textness params on ``device`` (None when not bundled)."""
    global _learned_numpy
    if _learned_numpy == "unset":
        from twinvoice_tpu_torch.ocr.torchocr.textness import load_textness

        try:
            _learned_numpy = load_textness()
        except Exception:
            _learned_numpy = None
    if _learned_numpy is None:
        return None
    key = str(device)
    if key not in _learned_on:
        _learned_on[key] = [{k: v.to(device) for k, v in p.items()}
                            for p in _learned_numpy]
    return _learned_on[key]


def detect_lines(
    image,
    *,
    min_area: int = 60,
    min_w: int = 8,
    min_h: int = 6,
    max_h_frac: float = 0.25,
    pad: int = 3,
    method: str = "auto",
    device=None,
) -> List[Box]:
    """PIL image / ndarray → text-line boxes, top-to-bottom, left-to-right.

    Rejects blobs that are implausible as text lines: tiny specks, tall
    blocks (QR codes) and full-page smears.

    ``method``: "classical" (adaptive threshold + anisotropic dilation),
    "learned" (the trained textness head), "hybrid" (classical boxes
    verified by the learned logit map, plus learned boxes the classical
    pass missed), or "auto" (hybrid when the learned weights are bundled,
    else classical). The maps run on ``device`` (None means ``"cuda"``).
    """
    device = resolve_device(device)
    arr = to_gray(image)
    h, w = arr.shape
    if method == "auto":
        method = "hybrid" if _learned(device) is not None else "classical"
    filt = dict(min_area=min_area, min_w=min_w, min_h=min_h,
                max_h_frac=max_h_frac, pad=pad)

    if method == "hybrid":
        from twinvoice_tpu_torch.ocr.torchocr.textness import textness_logits

        params = _learned(device)
        assert params is not None, "learned textness weights not bundled"
        logits = textness_logits(arr, params, device=device)
        cboxes = _boxes_from_map(_classical_map(arr, device), h, w, **filt)
        # verify each classical box against the learned map with a LOW bar
        # (fraction of weakly-positive pixels): the head's recall misses
        # whole faint lines, but inside a true line it is rarely all-cold,
        # while clutter/shadow components it was trained against stay cold
        kept = [
            b for b in cboxes
            if _warm_frac(logits, b, pad) >= _HYBRID_VERIFY_FRAC
        ]
        lboxes = _boxes_from_map((logits > 0.0).astype(np.uint8), h, w, **filt)
        for lb in lboxes:
            if all(_iou(lb, kb) < 0.3 for kb in kept):
                kept.append(lb)
        boxes = kept
    elif method == "learned":
        from twinvoice_tpu_torch.ocr.torchocr.textness import textness_map

        params = _learned(device)
        assert params is not None, "learned textness weights not bundled"
        dil = textness_map(arr, params, device=device).astype(np.uint8)
        boxes = _boxes_from_map(dil, h, w, **filt)
    else:
        boxes = _boxes_from_map(_classical_map(arr, device), h, w, **filt)
    boxes.sort(key=lambda b: (b[1] // 10, b[0]))
    return boxes


_HYBRID_VERIFY_FRAC = 0.10


def _classical_map(arr: np.ndarray, device) -> np.ndarray:
    """uint8 (H, W) gray → uint8 {0,1} dilated ink map (classical path), the
    page white-padded to multiples of 64 as the JAX map buckets it."""
    h, w = arr.shape
    page = torch.from_numpy(pad_page(arr)).to(device)[None]
    return _textness_map(page)[0, :h, :w].cpu().numpy().astype(np.uint8)


def _boxes_from_map(dil, h, w, *, min_area, min_w, min_h, max_h_frac,
                    pad) -> List[Box]:
    n, _, stats = connected_components_stats(dil)
    boxes: List[Box] = []
    for i in range(1, n):
        x, y, bw, bh, area = (int(v) for v in stats[i])
        if area < min_area or bw < min_w or bh < min_h:
            continue
        if bh > max_h_frac * h:          # QR blocks / page-scale smears
            continue
        if bh > 2.5 * bw:                # vertical strips aren't lines
            continue
        x1 = max(0, x - pad)
        y1 = max(0, y - pad)
        x2 = min(w, x + bw + pad)
        y2 = min(h, y + bh + pad)
        boxes.append((x1, y1, x2, y2))
    return boxes


def _warm_frac(logits: np.ndarray, box: Box, pad: int) -> float:
    """Fraction of weakly-positive (sigmoid > 0.3) learned-map pixels inside
    the un-padded box."""
    x1, y1, x2, y2 = box
    region = logits[y1 + pad : max(y1 + pad + 1, y2 - pad),
                    x1 + pad : max(x1 + pad + 1, x2 - pad)]
    if region.size == 0:
        return 0.0
    return float((region > -0.85).mean())   # logit(0.3) ≈ -0.85


def _iou(a: Box, b: Box) -> float:
    ax1, ay1, ax2, ay2 = a
    bx1, by1, bx2, by2 = b
    ix = max(0, min(ax2, bx2) - max(ax1, bx1))
    iy = max(0, min(ay2, by2) - max(ay1, by1))
    inter = ix * iy
    if inter == 0:
        return 0.0
    ua = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
    return inter / ua


_shared_engines = {}


def shared_engine(device=None):
    """One bundled :class:`~.engine.TorchOcrEngine` per device, made on first
    use (None means ``"cuda"``)."""
    from twinvoice_tpu_torch.ocr.torchocr.engine import TorchOcrEngine

    device = resolve_device(device)
    key = str(device)
    if key not in _shared_engines:
        _shared_engines[key] = TorchOcrEngine(device=device)
    return _shared_engines[key]


def read_page(
    image,
    engine=None,
    *,
    boxes: Optional[List[Box]] = None,
    min_confidence: float = 0.0,
    device=None,
):
    """Full-page OCR: detect lines, recognize each with the CTC engine.

    Returns ``[(box, OcrResult), ...]``. ``engine`` defaults to the shared
    bundled engine on ``device`` (None means ``"cuda"``); the detector runs
    on the engine's device.
    """
    if engine is None:
        engine = shared_engine(device)
    if not engine.available():
        return []
    arr = np.asarray(image.convert("L") if hasattr(image, "convert") else image)
    if boxes is None:
        boxes = detect_lines(arr, device=getattr(engine, "device", device))
    if not boxes:
        return []
    crops = [arr[y1:y2, x1:x2] for (x1, y1, x2, y2) in boxes]
    results = engine.read_batch(crops)
    return [
        (box, res)
        for box, res in zip(boxes, results)
        if res.text and res.confidence >= min_confidence
    ]


def read_text(image, engine=None, join: str = " ", *, device=None) -> str:
    """All recognized line texts of a page joined into one string."""
    return join.join(res.text for _, res in read_page(image, engine, device=device))
