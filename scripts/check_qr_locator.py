"""Hold the port's QR locator (``twinvoice_tpu_torch/qr/locate.py``) against
the installed OpenCV beyond the tests' pages, and time both on this host.

Three sets, each call preceded by the same seed for both generators
(``cv2.setRNGSeed``, ``locate.set_rng_seed``):

- ``--synthetic N`` frames: 1–4 codes of ``qr.encode.render_qr`` (modules
  1–7 px) on grey of random size up to 1400 px, some under a perspective
  warp, a turn, a blur, noise or lowered contrast;
- ``--perturbed N`` pages: ``render_invoice`` pages perturbed by
  ``twinvoice_tpu.data.augment.perturb`` (severity 0.2–1.0), scaled
  0.35–2.2×, some turned a quarter;
- the sweep's 82 pages (``chip_smoke.qr_sweep_pages``), timed: the median
  host ms a page of cv2's ``detectMulti``/``detect`` and of the port's
  ``locate_qr_quads``.

A page counts as equal when ``chip_smoke.qr_quads_equal`` finds nothing and
the generators' next four draws agree (the calls drew alike). Pages that
differ are saved as ``.npy`` under ``--out`` and listed.

    JAX_PLATFORMS=cpu python scripts/check_qr_locator.py --synthetic 600 --perturbed 240
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cv2_quads(cv2, det, gray):
    """The JAX scan's locator calls (``twinvoice_tpu/qr/detect.py:_detect_gray``)."""
    ok, pts = det.detectMulti(gray)
    if not ok or pts is None:
        ok, pts = det.detect(gray)
        ok = bool(ok) and pts is not None
    return [bool(ok), np.asarray(pts, np.float32).reshape(-1, 4, 2).tolist() if ok else []]


def synthetic(cv2, rng):
    from twinvoice_tpu_torch.qr.encode import render_qr

    q = render_qr("AB12345678" * int(rng.integers(1, 8)), module_px=int(rng.integers(1, 8)))
    h, w = (int(rng.integers(q.shape[i] + 10, 1400)) for i in (0, 1))
    img = np.full((h, w), int(rng.integers(120, 256)), np.uint8)
    for _ in range(int(rng.integers(1, 5))):
        y, x = int(rng.integers(0, h - q.shape[0])), int(rng.integers(0, w - q.shape[1]))
        img[y:y + q.shape[0], x:x + q.shape[1]] = np.minimum(img[y:y + q.shape[0], x:x + q.shape[1]], q)
    if rng.random() < 0.3:
        src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
        dst = (src + rng.uniform(-0.1, 0.1, (4, 2)) * [w, h]).astype(np.float32)
        img = cv2.warpPerspective(img, cv2.getPerspectiveTransform(src, dst), (w, h), borderValue=255)
    if rng.random() < 0.3:
        m = cv2.getRotationMatrix2D((w / 2, h / 2), float(rng.uniform(-45, 45)), 1.0)
        img = cv2.warpAffine(img, m, (w, h), borderValue=255)
    if rng.random() < 0.3:
        img = cv2.GaussianBlur(img, (0, 0), float(rng.uniform(0.5, 2)))
    if rng.random() < 0.3:
        img = np.clip(img.astype(int) + rng.integers(-50, 50, img.shape), 0, 255).astype(np.uint8)
    if rng.random() < 0.2:
        img = (img.astype(np.float32) * rng.uniform(0.2, 0.6) + rng.uniform(50, 150)).astype(np.uint8)
    return img


def perturbed(cv2, rng):
    from twinvoice_tpu.data.augment import perturb
    from twinvoice_tpu.data.synthetic import render_invoice

    img, _ = render_invoice(seed=int(rng.integers(0, 10000)), layout_jitter=float(rng.uniform(0, 1)))
    out = perturb(np.asarray(img.convert("RGB")), None, rng, severity=float(rng.uniform(0.2, 1.0)))
    rgb = out[0] if isinstance(out, tuple) else out
    sc = float(rng.uniform(0.35, 2.2))
    rgb = cv2.resize(rgb, None, fx=sc, fy=sc,
                     interpolation=cv2.INTER_AREA if sc < 1 else cv2.INTER_LINEAR)
    if rng.random() < 0.3:
        rgb = np.ascontiguousarray(np.rot90(rgb, int(rng.integers(1, 4))))
    return cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--synthetic", type=int, default=200)
    ap.add_argument("--perturbed", type=int, default=80)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "qr_locator_diffs"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import cv2

    import chip_smoke
    from twinvoice_tpu_torch.ops.host_image import rgb_to_gray
    from twinvoice_tpu_torch.qr import locate

    def rng_draws():
        out = np.zeros(4, np.int32)
        cv2.randu(out, 0, 1 << 16)
        return out.tolist()

    rng = np.random.default_rng(args.seed)
    det = cv2.QRCodeDetector()
    for name, make, n in (("synthetic", synthetic, args.synthetic),
                          ("perturbed", perturbed, args.perturbed)):
        differ = found = 0
        for t in range(n):
            gray = make(cv2, rng)
            seed = int(rng.integers(0, 1000))
            cv2.setRNGSeed(seed)
            want = cv2_quads(cv2, det, gray)
            locate.set_rng_seed(seed)
            why = chip_smoke.qr_quads_equal(locate.locate_qr_quads(gray), want)
            if why is None and rng_draws() != [locate.rng_next() & 0xFFFF for _ in range(4)]:
                why = "the generators drew differently"
            found += want[0]
            if why:
                differ += 1
                os.makedirs(args.out, exist_ok=True)
                path = os.path.join(args.out, f"{name}_{args.seed}_{t}.npy")
                np.save(path, gray)
                print(f"{name} {t}: {gray.shape}, seed {seed}: {why} ({path})", flush=True)
        print(f"{name}: {n - differ} of {n} pages equal to cv2's ({found} with a code found)",
              flush=True)

    fix = chip_smoke.qr_fixture()
    cv_ms, port_ms = [], []
    for page in chip_smoke.qr_sweep_pages(fix).values():
        gray = rgb_to_gray(page)
        cv2.setRNGSeed(0)
        t = time.perf_counter()
        cv2_quads(cv2, det, gray)
        cv_ms.append(1e3 * (time.perf_counter() - t))
        locate.set_rng_seed(0)
        t = time.perf_counter()
        locate.locate_qr_quads(gray)
        port_ms.append(1e3 * (time.perf_counter() - t))
    print(f"sweep, {len(cv_ms)} pages, host ms a page (median): cv2 {np.median(cv_ms):.2f}, "
          f"the port {np.median(port_ms):.2f} (cv2 {cv2.__version__}, "
          f"{os.cpu_count()} cores)", flush=True)


if __name__ == "__main__":
    main()
