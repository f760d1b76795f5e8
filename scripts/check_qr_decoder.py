"""Hold the port's rebuild of ``cv2.QRCodeDetector``'s decoder (``qr.cvdecode``)
against the installed OpenCV on seeded synthetic frames, beyond the tests.

Each frame is a code of the JAX package's encoder (a random version 1-40,
level, mask and byte payload), rendered at 2-5 pixels a module, warped by a
random perspective, blurred or not and scaled or not; every fifth is damaged
(codewords flipped in one block, near and past the correction limit). On
each, cv2's ``detectAndDecodeMulti`` and ``detectAndDecode`` (after
``cv2.setRNGSeed(0)``) against the port's (after ``locate.set_rng_seed(0)``):
strings, ``ok`` flags and raises. A frame that differs is saved under
``build/qr_decoder_diffs/``.

    JAX_PLATFORMS=cpu python scripts/check_qr_decoder.py --frames 300 [--seed N]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def frame(rng, k):
    import cv2

    import make_torch_smoke_qrdecode as mk
    from twinvoice_tpu.qr.encode import _data_capacity_bytes, encode_qr_matrix

    v = int(rng.integers(1, 41)) if k % 3 else int(rng.integers(1, 8))
    level, mask = "LMQH"[k % 4], int(rng.integers(0, 8))
    if k % 5 == 4:
        block = 0
        ecc = len(mk.blocks_of(mk.byte_segment(b"x", v), v, level)[1][0])
        m = mk.damaged(v, level, block, ecc // 2 - 1 + int(rng.integers(0, 3)), rng, mask)
    else:
        n = min(int(rng.integers(1, 30)), _data_capacity_bytes(v, level) - 3)
        m = encode_qr_matrix(bytes(rng.integers(32, 127, n).astype(np.uint8)), level=level,
                             mask=mask, version=v)
    px = int(rng.integers(2, 6)) if m.shape[0] < 80 else int(rng.integers(2, 4))
    img = np.pad(mk.render(m, px), 40, constant_values=255)
    h, w = img.shape
    src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
    dst = (src + rng.normal(scale=float(rng.uniform(0, 12)), size=(4, 2))).astype(np.float32)
    img = cv2.warpPerspective(img, cv2.getPerspectiveTransform(src, dst), (w, h),
                              flags=cv2.INTER_LINEAR, borderValue=255)
    if rng.integers(0, 2):
        img = cv2.GaussianBlur(img, (3, 3), 0.8)
    if rng.integers(0, 2):
        sc = float(rng.uniform(0.5, 1.0))
        img = cv2.resize(img, None, fx=sc, fy=sc, interpolation=cv2.INTER_AREA)
    return f"v{v}{level}m{mask}px{px}", img


def main():
    import cv2

    import chip_smoke
    import make_torch_smoke_qrdecode as mk

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    out_dir = os.path.join(ROOT, "build", "qr_decoder_diffs")
    t0 = time.time()
    differ = decoded = 0
    for k in range(args.frames):
        name, gray = frame(rng, k)
        want, got = mk.cv2_results(gray), chip_smoke.cvdecode_results(gray)
        decoded += bool(want["single"][0] == "ok" and want["single"][1])
        if want != got:
            differ += 1
            os.makedirs(out_dir, exist_ok=True)
            np.save(os.path.join(out_dir, f"seed{args.seed}_{k}_{name}.npy"), gray)
            print(f"frame {k} {name} {gray.shape}: cv2 {want}, port {got}", flush=True)
    print(f"{args.frames} frames (seed {args.seed}), {decoded} read by cv2's detectAndDecode: "
          f"{differ} differ; {time.time() - t0:.1f} s (cv2 {cv2.__version__})")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
