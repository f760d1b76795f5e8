"""The quality gauntlet on the PyTorch port (``scripts/eval_gauntlet.py``'s
counterpart): IoU, box-hit and end-to-end accuracy that the models can fail,
on held-out content seeds, held-out fonts, photographic perturbations and
the dot-matrix print medium (``twinvoice_tpu_torch.eval.gauntlet``).

Usage:
  python scripts/eval_torch_gauntlet.py [--n 25] [--e2e] [--int8] \
      [--variant name=weights.npz:width[:grid]] ... [--device cuda|cpu]

Default variants: every ``segmenter_synth_*.npz`` bundled under
``twinvoice_tpu/models/weights`` (read as data, without the JAX package).
Every case is rendered and perturbed by the port (no Pillow, OpenCV or
JAX), so it runs on a machine with only PyTorch and numpy; the segmenters
and the OCR engine run on the card unless ``--device cpu``. Prints one JSON
line per (variant, level) and the markdown summary table of
``eval_gauntlet.py``.
"""

import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WEIGHTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "twinvoice_tpu", "models", "weights",
)

# (level, base set): "std" = training fonts, "heldout" = held-out fonts,
# "dot" = the dot-matrix printhead on the training fonts (the print-medium axis)
LEVEL_SETS = [
    ("clean", "std"), ("mild", "std"), ("hard", "std"),
    ("clean", "heldout"), ("mild", "heldout"),
    # real-photo scenario tiers (eval.gauntlet.SCENARIOS)
    ("printscan", "std"), ("screenshot", "std"),
    ("crumple", "std"), ("thermal", "std"),
    ("clean", "dot"), ("mild", "dot"),
]

_BASE_SUFFIX = {"std": "", "heldout": "+heldoutfont", "dot": "+dotprint"}

# make_base_cases's arguments for each base set
BASES = {"std": {"use_heldout_fonts": False},
         "heldout": {"seed": 888_000, "use_heldout_fonts": True},
         "dot": {"seed": 999_000, "dot_print": True}}


def discover_variants():
    out = []
    for f in sorted(os.listdir(WEIGHTS_DIR)):
        m = re.match(r"segmenter_synth_w(\d+)(?:_g(\d+))?\.npz$", f)
        if m:
            out.append((f.removesuffix(".npz"), os.path.join(WEIGHTS_DIR, f),
                        int(m.group(1)), int(m.group(2) or 512)))
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=25)
    ap.add_argument("--e2e", action="store_true",
                    help="also run full-pipeline field accuracy (slow)")
    ap.add_argument("--variant", action="append", default=[],
                    help="name=weights.npz:width[:grid]")
    ap.add_argument("--int8", action="store_true",
                    help="also evaluate each variant's int8-quantized serving "
                         "mode (calibrated on clean renders)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def case_sets(n):
    """{(level, base): cases}: the three base sets, each tier perturbed."""
    from twinvoice_tpu_torch.eval import make_base_cases, perturb_cases

    bases = {base: make_base_cases(n, **kw) for base, kw in BASES.items()}
    return {(level, base): perturb_cases(bases[base], level, seed=7)
            for level, base in LEVEL_SETS}


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from twinvoice_tpu_torch.config import InferConfig, UNetConfig
    from twinvoice_tpu_torch.eval.gauntlet import _resize_case
    from twinvoice_tpu_torch.infer.pipeline import Segmenter
    from twinvoice_tpu_torch.weights import load_npz

    variants = []
    for spec in args.variant:
        name, rest = spec.split("=", 1)
        parts = rest.split(":")
        variants.append((name, parts[0], int(parts[1]),
                         int(parts[2]) if len(parts) > 2 else 512))
    if not variants:
        variants = discover_variants()
    if not variants:
        print(json.dumps({"error": "no segmenter weights found"}))
        return

    sets = case_sets(args.n)

    def calib_batches(grid, k=8):
        """Clean in-distribution renders at the serving grid: the int8
        activation-scale calibration set."""
        cases = sets[("clean", "std")][:k]
        return [np.stack([_resize_case(c, grid)[0] for c in cases]).astype(np.uint8)]

    seg_modes = [("", None)]
    if args.int8:
        seg_modes.append(("+int8", "int8"))

    rows = []
    for name, path, width, grid in variants:
        if not os.path.exists(path):
            print(json.dumps({"variant": name, "error": f"missing {path}"}), flush=True)
            continue
        params, bn = load_npz(path)
        for suffix, mode in seg_modes:
            kw = {"int8_calib": calib_batches(grid)} if mode == "int8" else {}
            seg = Segmenter(params, bn, UNetConfig(base_width=width),
                            InferConfig(img_size=grid), dtype=torch.bfloat16,
                            device=args.device, **kw)
            _eval_variant(name + suffix, seg, grid, width, args, sets, rows)

    _print_summary(rows)


def _eval_variant(name, seg, grid, width, args, sets, rows):
    from twinvoice_tpu_torch.eval import run_e2e_gauntlet, run_segmenter_gauntlet

    row = {"variant": name, "width": width, "grid": grid}
    for (level, base), cases in sets.items():
        key = f"{level}{_BASE_SUFFIX[base]}"
        res = run_segmenter_gauntlet(seg, cases)
        row[key] = {"iou": round(res["iou_mean"], 3),
                    "box_hit": round(res["box_hit_mean"], 3)}
        print(json.dumps({"variant": name, "level": key, **res}), flush=True)
    if args.e2e:
        from twinvoice_tpu_torch.config import FusionConfig
        from twinvoice_tpu_torch.fusion.extract import InvoiceExtractor
        from twinvoice_tpu_torch.ocr.torchocr.engine import TorchOcrEngine

        engine = TorchOcrEngine(device=args.device)
        if engine.available():
            ex = InvoiceExtractor(seg, None, engines=[engine],
                                  cfg=FusionConfig(use_qr=False, auto_rotate=False))
            for level in ("clean", "mild"):
                res = run_e2e_gauntlet(ex, sets[(level, "std")])
                row[f"e2e_{level}"] = res
                print(json.dumps({"variant": name, "e2e": level, **res}), flush=True)
    rows.append(row)


def _print_summary(rows):
    keys = [f"{lv}{_BASE_SUFFIX[b]}" for lv, b in LEVEL_SETS]
    print("\n| variant | grid | " + " | ".join(f"{k} IoU/hit" for k in keys) + " |")
    print("|" + "---|" * (len(keys) + 2))
    for row in rows:
        cells = [f"{row[k]['iou']:.2f}/{row[k]['box_hit']:.2f}" for k in keys]
        print(f"| {row['variant']} | {row['grid']} | " + " | ".join(cells) + " |")


if __name__ == "__main__":
    main()
