"""QR detection + decode pipeline: the port of ``twinvoice_tpu.qr.detect``.

The same cascade, early stop and payload filter as the JAX ``QrPipeline``
(``qr/detect.py:152-262``). Decode is a pluggable protocol: the in-repo C++
decoder (``qr.native``), ``cv2.QRCodeDetector``, or any callable ``ndarray
-> list[str]``.

Every pass runs without OpenCV, on any machine: the 0.75× INTER_AREA gray
(pass 1), the region pass on the port's locator (``qr.locate``:
``cv2.QRCodeDetector``'s own localisation, ``detectMulti`` then ``detect``,
rebuilt in host C++, so its boxes are the JAX scan's), the full frame, the
enhanced region retries (``ops.host_image``'s ``equalizeHist`` and 3×
INTER_CUBIC), the two half tiles and the 2× linear last resort. The one
OpenCV step left is the ``opencv_decode`` backend, cv2's own decoder: the
default decoders add it where cv2 imports; where it does not, a candidate
the native decoder did not read is counted ``opencv_decode_skipped`` with a
``UserWarning``. ``passes`` counts each pass a scan ran (a candidate image
handed to the decoders) and each skip, by name.
"""

from __future__ import annotations

import collections
import threading
import warnings
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from twinvoice_tpu_torch.ops.host_image import (
    equalize_hist_u8,
    gray_to_rgb,
    resize_area_u8,
    resize_cubic_u8,
    resize_linear_u8,
    rgb_to_gray,
)
from twinvoice_tpu_torch.qr import native
from twinvoice_tpu_torch.qr.locate import locate_qr_boxes
from twinvoice_tpu_torch.qr.parse import is_text_qr_payload, parse_header_qr

QrDecodeFn = Callable[[np.ndarray], List[str]]

MIN_PAYLOAD_LEN = 20  # reference keeps only >20-char strings (app_camera.py:542)

# pass name → candidates scanned (or skips) since it was last cleared: "gray_0.75",
# "regions" (a locator call), "region_crop", "full_frame", "enhanced",
# "half_tile", "upscale_2x", and "opencv_decode_skipped"
passes: collections.Counter = collections.Counter()
_passes_lock = threading.Lock()  # scans run from extract_batch's thread pool


def count_pass(name: str):
    with _passes_lock:
        passes[name] += 1


def cv2_available() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def detect_qr_regions(rgb: np.ndarray) -> List[Tuple[int, int, int, int]]:
    """Locate likely QR bounding boxes (x1, y1, x2, y2) in a uint8 RGB (or
    gray) array with ``qr.locate.locate_qr_boxes`` (cv2's ``detectMulti``,
    then ``detect``, as the JAX package calls them). Frames wider than
    ``_DETECT_MAX_DIM`` are first scanned at an INTER_AREA downscale; fewer
    than 2 boxes there falls back to the full resolution, as JAX's does.
    Boxes are in full-resolution coordinates, scaled back as the JAX
    package scales cv2's."""
    gray = rgb_to_gray(rgb) if rgb.ndim == 3 else rgb
    scale = max(gray.shape) / float(_DETECT_MAX_DIM)
    if scale > 1.0:
        small = resize_area_u8(gray, int(gray.shape[1] / scale), int(gray.shape[0] / scale))
        boxes = locate_qr_boxes(small)
        if len(boxes) >= 2:
            return [
                (int(x1 * scale), int(y1 * scale),
                 min(int(x2 * scale + 1), gray.shape[1]),
                 min(int(y2 * scale + 1), gray.shape[0]))
                for (x1, y1, x2, y2) in boxes
            ]
    return locate_qr_boxes(gray)


# only downscale genuinely large frames (phone photos): the locator needs
# ~2 px per module
_DETECT_MAX_DIM = 800


_TLS = threading.local()


def _detector(cv2):
    # one detector per thread: cv2 detectors are not documented thread-safe
    det = getattr(_TLS, "qr_detector", None)
    if det is None:
        det = _TLS.qr_detector = cv2.QRCodeDetector()
    return det


def enhance_qr_region(rgb_crop: np.ndarray, upscale: int = 3) -> np.ndarray:
    """Contrast-equalize and upsample a QR crop (app_camera.py:351-365
    behavior): OpenCV's gray, ``equalizeHist``, ``upscale``× INTER_CUBIC
    and gray → RGB, in numpy."""
    gray = equalize_hist_u8(rgb_to_gray(rgb_crop))
    return gray_to_rgb(resize_cubic_u8(gray, fx=upscale, fy=upscale))


def opencv_decode(rgb: np.ndarray) -> List[str]:
    """Decode backend built on cv2.QRCodeDetector (multi + single). Needs
    OpenCV."""
    import cv2

    gray = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY) if rgb.ndim == 3 else rgb
    det = _detector(cv2)
    out: List[str] = []
    try:
        ok, texts, _, _ = det.detectAndDecodeMulti(gray)
        if ok:
            out.extend(t for t in texts if t)
    except cv2.error:
        pass
    if not out:
        try:
            text, _, _ = det.detectAndDecode(gray)
            if text:
                out.append(text)
        except cv2.error:
            pass
    return out


def native_decode(rgb: np.ndarray) -> List[str]:
    """Decode backend using the in-repo C++ decoder (``qr.native``)."""
    return native.decode(rgb)


class QrPipeline:
    """Full-image QR scan: a cheap downscaled pass, detected regions, the
    full frame, enhanced region retries and half tiles; an upscaled
    full-frame pass when nothing was found."""

    def __init__(self, decoders: Optional[Sequence[QrDecodeFn]] = None,
                 min_len: int = MIN_PAYLOAD_LEN, max_payloads: int = 2):
        """``decoders``: tried in order on each candidate, the first that
        reads anything wins. The default is the native decoder, then
        ``opencv_decode`` where cv2 imports; it loads (and if need be
        builds) the native library here, and raises if it cannot.
        ``max_payloads``: stop once this many distinct payloads decoded and
        both invoice QR roles are covered (0 disables the early stop)."""
        self._skipped_decoder = False
        if decoders is None:
            native.load()
            decoders = [native_decode]
            if cv2_available():
                decoders.append(opencv_decode)
            else:
                self._skipped_decoder = True
        self.decoders = list(decoders)
        self.min_len = min_len
        self.max_payloads = max_payloads

    def _decode_all(self, arr: np.ndarray) -> List[str]:
        out: List[str] = []
        for dec in self.decoders:
            try:
                out.extend(dec(arr))
            except Exception:  # noqa: BLE001 - a backend that fails reads nothing
                continue
            if out:
                break  # first backend that reads anything wins
        if not out and self._skipped_decoder:
            count_pass("opencv_decode_skipped")
            warnings.warn("OpenCV is not importable: skipped the opencv_decode backend "
                          "on a candidate the native decoder did not read", UserWarning,
                          stacklevel=3)
        return out

    def scan(self, image) -> List[str]:
        """``image``: uint8 RGB ndarray (or a PIL image) → unique payloads.

        A payload survives if it is ≥ min_len or starts with ``**`` (the
        TEXT QR is often shorter than 20 chars). Candidates are built lazily
        so the early stop skips their work too.
        """
        rgb = np.asarray(image.convert("RGB") if hasattr(image, "convert") else image)

        def candidates():
            # 0.75× INTER_AREA gray first: the native finder scan is
            # ~O(pixels), and on a clean invoice this pass reads both QRs
            if max(rgb.shape[:2]) >= 420:
                count_pass("gray_0.75")
                yield resize_area_u8(rgb_to_gray(rgb), fx=0.75, fy=0.75)
            # then detected-region crops (a full-res crop decodes in a few
            # ms where the full frame may not), the misses kept for the
            # enhanced retries
            count_pass("regions")
            misses = []
            for (x1, y1, x2, y2) in detect_qr_regions(rgb):
                crop = rgb[y1:y2, x1:x2]
                n_before = len(found)
                count_pass("region_crop")
                yield crop
                if len(found) == n_before:
                    misses.append(crop)
            count_pass("full_frame")
            yield rgb
            for crop in misses:
                count_pass("enhanced")
                yield enhance_qr_region(crop)
            w = rgb.shape[1]
            count_pass("half_tile")
            yield rgb[:, : w // 2]
            count_pass("half_tile")
            yield rgb[:, w // 2 :]

        found: List[str] = []

        def absorb(arr):
            for txt in self._decode_all(arr):
                txt = txt.strip()
                if (len(txt) >= self.min_len or txt.startswith("**")) and (
                        txt not in found):
                    found.append(txt)

        def roles_satisfied():
            # early-stop only once both invoice QR roles are covered: a
            # header payload (invoice no + parseable ROC date) and a TEXT one
            inv_no, date = parse_header_qr(found)
            has_header = inv_no is not None and date is not None
            has_text = any(is_text_qr_payload(s) for s in found)
            return has_header and has_text

        for arr in candidates():
            absorb(arr)
            if (
                self.max_payloads
                and len(found) >= self.max_payloads
                and roles_satisfied()
            ):
                return found
        if not found:  # last resort: 2× upscale of the full frame
            count_pass("upscale_2x")
            absorb(resize_linear_u8(rgb, fx=2, fy=2))
        return found
