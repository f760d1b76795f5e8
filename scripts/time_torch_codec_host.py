#!/usr/bin/env python3
"""Host times of the port's JPEG codec beside OpenCV's, on one CPU.

    python scripts/time_torch_codec_host.py [--reps 3]

Needs OpenCV (``cv2``), so it runs where the JAX package's tests run, not on
a machine without it. On the frames ``chip_smoke.py`` phase 30 (b) uses (the
training fixture's 512² page; the 4032×3024 phone photos of
``chip_smoke.phone_photos``: the page upscaled, and the same under noise and
texture) it times, at q95:

- ``encode_jpeg`` (and of it the host C++ library's scan) beside
  ``cv2.imencode(".jpg", ...)``, and checks the bytes equal;
- ``decode_jpeg`` (and of it the scan) beside ``cv2.imdecode``, and checks
  the pixels equal.

Each figure is the median host ms of ``--reps`` calls in this one process,
printed beside the CPU it ran on. No card is used.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import cv2
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from twinvoice_tpu_torch.ops.host_jpeg import decode_jpeg, encode_jpeg  # noqa: E402


def median_ms(fn, reps):
    """→ (the median host ms of ``reps`` calls of ``fn``, its last result)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def time_frame(name, rgb, quality, reps):
    """One frame: the port's and cv2's encode and decode, printed."""
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    with chip_smoke.scan_timer() as scan:
        enc_ms, data = median_ms(lambda: encode_jpeg(rgb, quality), reps)
        enc_scan = scan["jpeg_encode_scan"] / reps
        dec_ms, got = median_ms(lambda: decode_jpeg(data), reps)
        dec_scan = scan["jpeg_decode_scan"] / reps
    cv_enc_ms, buf = median_ms(lambda: cv2.imencode(".jpg", bgr, params)[1], reps)
    cv_dec_ms, want = median_ms(lambda: cv2.imdecode(buf, cv2.IMREAD_COLOR), reps)
    same_bytes = data == buf.tobytes()
    same_pixels = np.array_equal(got, want[..., ::-1])
    h, w = rgb.shape[:2]
    print(f"{name} {w}×{h} q{quality} ({len(data)} bytes): encode_jpeg {enc_ms:.1f} ms "
          f"(the C++ scan {enc_scan:.1f} a call) vs cv2.imencode {cv_enc_ms:.1f} ms "
          f"({enc_ms / cv_enc_ms:.1f}×), bytes equal {same_bytes}; decode_jpeg {dec_ms:.1f} "
          f"ms (the C++ scan {dec_scan:.1f} a call) vs cv2.imdecode {cv_dec_ms:.1f} ms "
          f"({dec_ms / cv_dec_ms:.1f}×), pixels equal {same_pixels}", flush=True)
    if not (same_bytes and same_pixels):
        raise SystemExit(f"{name}: the port's codec disagrees with cv2")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3, help="calls a figure is the median of")
    ap.add_argument("--quality", type=int, default=chip_smoke.PHONE_QUALITY)
    args = ap.parse_args(argv)
    print(f"host: {chip_smoke.host_cpu()}; OpenCV {cv2.__version__}, "
          f"{cv2.getNumThreads()} threads; median of {args.reps} calls each", flush=True)
    page = chip_smoke.train_fixture()["pages"][0]
    time_frame("training page", page, args.quality, max(args.reps, chip_smoke.SMALL_ENCODES))
    for name, photo in chip_smoke.phone_photos(page).items():
        time_frame(name, photo, args.quality, args.reps)


if __name__ == "__main__":
    main()
