"""Hold the port's text rendering against Pillow and the JAX renderers on
seeded sweeps, beyond the tests.

- ``--strings N``: N random charset strings (1–19 characters) in the
  training faces at sizes 10–29, every other one at a random fractional
  ``start``: ``getmask2``'s mask and offset and ``getlength`` against
  Pillow's;
- ``--batches N``: N ``make_batch(4, ...)`` calls with every fraction (a
  third of them with the CJK charset and the mixed sampler) against JAX's,
  lines, texts and the generator's state;
- ``--pages N``: N ``render_textpage`` pages at severity 0, 0.5 and 1.0 in
  turn against JAX's: masks and generator states, and how many images
  differ (the perturbation engine's float32 stages keep their own bound,
  ``tests/test_torch_augment.py``).

Both registries are whole (the 14 training fonts on this machine, the
same faces in the same order); ``--ipp on|off`` sets ``cv2.ipp.setUseIPP``
(the lines equal JAX's with it off). Prints each mismatch and a count per
part.

    JAX_PLATFORMS=cpu python scripts/check_torch_render.py --strings 3000 \\
        --batches 400 --pages 300 [--seed 1] [--ipp off]    # ~1 min
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--strings", type=int, default=3000)
    ap.add_argument("--batches", type=int, default=400)
    ap.add_argument("--pages", type=int, default=300)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--ipp", choices=("on", "off"), default="off")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import cv2
    from PIL import ImageFont

    import twinvoice_tpu.data.synthetic as jax_synthetic
    import twinvoice_tpu.ocr.jaxocr.data as J
    import twinvoice_tpu_torch.data.synthetic as port_synthetic
    import twinvoice_tpu_torch.ocr.torchocr.data as P
    from twinvoice_tpu.ocr.jaxocr import textness as JT
    from twinvoice_tpu.ocr.jaxocr.charset import cjk_charset as jax_cjk
    from twinvoice_tpu_torch.ocr.fonts.truetype import FreeTypeFont
    from twinvoice_tpu_torch.ocr.torchocr import textness as PT
    from twinvoice_tpu_torch.ocr.torchocr.charset import CHARSET
    from twinvoice_tpu_torch.ocr.torchocr.charset import cjk_charset as port_cjk

    cv2.ipp.setUseIPP(args.ipp == "on")
    jf, pf = jax_synthetic.train_fonts(), port_synthetic.train_fonts()
    assert [os.path.basename(f) for f in jf] == [os.path.basename(f) for f in pf], (jf, pf)
    rng = np.random.default_rng(args.seed)
    chars = list(CHARSET)

    t0, bad = time.perf_counter(), 0
    for i in range(args.strings):
        k, size = int(rng.integers(0, len(jf))), int(rng.integers(10, 30))
        text = "".join(rng.choice(chars, int(rng.integers(1, 20))))
        start = (float(rng.random()), float(rng.random())) if i % 2 else (0.0, 0.0)
        pil, port = ImageFont.truetype(jf[k], size), FreeTypeFont(pf[k], size)
        m, off = pil.getmask2(text, "L", start=start)
        want = np.array(m, np.uint8).reshape(m.size[1], m.size[0])
        got, goff = port.getmask2(text, start)
        if (goff != off or got.shape != want.shape or not np.array_equal(got, want)
                or port.getlength(text) != pil.getlength(text)):
            bad += 1
            print(f"string: {os.path.basename(jf[k])} {size} {text!r} start {start}", flush=True)
    print(f"strings: {bad} of {args.strings} differ ({time.perf_counter() - t0:.1f} s)", flush=True)

    t0, bad = time.perf_counter(), 0
    for i in range(args.batches):
        seed = args.seed * 100_000 + i
        cjk = i % 3 == 0
        kw = dict(hard_frac=0.2, sev_frac=0.3, dot_frac=0.4, synth_frac=0.3, dot_hard_frac=0.3,
                  mixed_frac=0.3 if cjk else 0.0)
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        a = J.make_batch(4, r1, jax_cjk() if cjk else J.DEFAULT, **kw)
        b = P.make_batch(4, r2, port_cjk() if cjk else P.DEFAULT, **kw)
        if not (np.array_equal(a[0], b[0]) and a[3] == b[3]
                and r1.bit_generator.state == r2.bit_generator.state):
            bad += 1
            print(f"batch: seed {seed} cjk {cjk}", flush=True)
    print(f"batches: {bad} of {args.batches} differ ({time.perf_counter() - t0:.1f} s)", flush=True)

    t0, bad, off = time.perf_counter(), 0, 0
    for i in range(args.pages):
        seed, severity = args.seed * 100_000 + i, (0.0, 0.5, 1.0)[i % 3]
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        (g1, m1), (g2, m2) = (JT.render_textpage(r1, severity=severity),
                              PT.render_textpage(r2, severity=severity))
        if not (np.array_equal(m1, m2) and r1.bit_generator.state == r2.bit_generator.state):
            bad += 1
            print(f"page: seed {seed} severity {severity}: mask or state differs", flush=True)
        elif not np.array_equal(g1, g2):
            off += 1
            d = np.abs(g1.astype(np.int16) - g2.astype(np.int16))
            print(f"page: seed {seed} severity {severity}: {int((d > 0).sum())} pixels differ, "
                  f"by at most {int(d.max())}", flush=True)
    print(f"pages: {bad} of {args.pages} with another mask or state, {off} with another image "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
