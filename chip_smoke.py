#!/usr/bin/env python3
"""Drive the PyTorch port (``twinvoice_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, each printing one line with its wall time:

1. device: the card's name and ``nvidia-smi`` name and power limit
2. build every CUDA kernel of the port from ``twinvoice_tpu_torch/csrc``
3. K1 (``ops.bbox_postprocess``) against its plain PyTorch version on the
   card: exact equality of boxes and valid flags on planted rectangles
   (float32 and bfloat16), all-below and all-above logits, H≠W, odd widths,
   NHWC-contiguous and strided layouts, and the serving shape
4. the main path at float32 (TF32 off): the bundled w16 segmenter,
   ``segment_batch(pre_resized=False)`` on the fixture pages, crops with
   ``crop_fields``; valid and ok flags equal to the JAX package's (stored in
   ``tests/data/torch_smoke_pages.npz``), grid boxes within one grid cell
5. the same pages at bfloat16, agreement with float32
6. a batch of 128 at 512², pre-resized, box-only, bfloat16: img/s with the
   boxes read back to the host after every batch (``bench.py``'s serial
   protocol)
7. K1's time on the model's serving logits against its bound and the plain
   version's

Kernel launch counts are zeroed before phase 4 and read after phase 6's
batches, before phase 7's timing launches, so they show that the main path
ran the kernels.

It imports torch, numpy, the standard library and ``twinvoice_tpu_torch``
only. Without a CUDA device, or if any phase fails, it exits non-zero and
prints no result line. Its last lines are the card's name and power limit,
one JSON object per kernel row, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from twinvoice_tpu_torch import _build  # noqa: E402
from twinvoice_tpu_torch.infer.pipeline import crop_fields  # noqa: E402
from twinvoice_tpu_torch.infer.postprocess import (  # noqa: E402
    bbox_from_probs,
    probability_to_logit_thresholds,
)
from twinvoice_tpu_torch.models.pretrained import load_pretrained_segmenter  # noqa: E402
from twinvoice_tpu_torch.models.unet import unet_apply_folded  # noqa: E402
from twinvoice_tpu_torch.ops import bbox_postprocess as k1  # noqa: E402
from twinvoice_tpu_torch.ops.image import resize_bilinear  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "data", "torch_smoke_pages.npz")
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, fp32 outside tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SERVE_BATCH = 128
SERVE_ITERS = 20


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class Phases:
    def __init__(self):
        self.t0 = time.perf_counter()

    def run(self, n, name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"[phase {n}] {name}: ok in {time.perf_counter() - t:.2f} s "
              f"(total {time.perf_counter() - self.t0:.2f} s)", flush=True)
        return out


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 1-2 ---------------------------------------------------------------


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing to run")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name}; nvidia-smi: {card}; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}; devices {torch.cuda.device_count()}",
          flush=True)
    return name, card


def phase_build():
    for name, path in _build.build().items():
        print(f"built {name}: {os.path.relpath(path, ROOT)}", flush=True)


# -- phase 3: K1 against its plain version -----------------------------------


def planted_logits(g, b, h, w, c, dtype, nchw=False):
    """Background logits far below the thresholds, with a random rectangle of
    high logits planted in most (image, class) planes and a few lone pixels."""
    shape = (b, c, h, w) if nchw else (b, h, w, c)
    x = torch.randn(shape, generator=g, device="cuda") - 6.0
    planes = x if nchw else x.permute(0, 3, 1, 2)  # (b, c, h, w) view
    for bi in range(b):
        for ci in range(c):
            r = torch.randint(0, 10, (6,), generator=g, device="cuda").tolist()
            if r[0] < 2:
                continue  # leave this class empty: sentinel box
            y0, x0 = r[1] * h // 10, r[2] * w // 10
            y1 = min(h, y0 + 1 + r[3] * h // 10)
            x1 = min(w, x0 + 1 + r[4] * w // 10)
            planes[bi, ci, y0:y1, x0:x1] += 8.0
            if r[5] > 6:  # a lone pixel outside the rectangle
                planes[bi, ci, (y0 * 7 + 3) % h, (x0 * 13 + 5) % w] = 4.0
    x = x.to(dtype)
    return x.permute(0, 2, 3, 1) if nchw else x


def check_k1(label, logits, thr):
    boxes, valid = k1.bbox_postprocess(logits, thr)
    rb, rv = k1.bbox_postprocess_reference(logits, thr)
    torch.cuda.synchronize()
    if not (torch.equal(valid, rv) and torch.equal(boxes, rb)):
        bad = (boxes != rb).any(-1) | (valid != rv)
        idx = bad.nonzero()[:4].tolist()
        raise AssertionError(
            f"K1 {label}: kernel != plain at (b,c) {idx}: "
            f"{[boxes[i, j].tolist() for i, j in idx]} vs "
            f"{[rb[i, j].tolist() for i, j in idx]}")
    err = int((boxes.to(torch.int64) - rb.to(torch.int64)).abs().max()) \
        if boxes.numel() else 0
    print(f"  K1 {label} {tuple(logits.shape)} {logits.dtype} strides "
          f"{logits.stride()}: equal ({int(valid.sum())}/{valid.numel()} valid)",
          flush=True)
    return err


def phase_k1(thr):
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    err = 0
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        err = max(err, check_k1(f"planted {tag}",
                                planted_logits(g, 4, 96, 128, 3, dtype), thr))
        err = max(err, check_k1(f"planted NCHW view {tag}",
                                planted_logits(g, 4, 64, 64, 3, dtype, nchw=True), thr))
        for nchw in (False, True):
            lay = "NCHW view" if nchw else "NHWC"
            err = max(err, check_k1(f"H!=W {lay} {tag}",
                                    planted_logits(g, 3, 40, 72, 3, dtype, nchw), thr))
            err = max(err, check_k1(f"odd W {lay} {tag}",
                                    planted_logits(g, 2, 33, 37, 3, dtype, nchw), thr))
        base = planted_logits(g, 2, 64, 96, 3, dtype, nchw=True)
        err = max(err, check_k1(f"row-strided slice {tag}", base[:, ::2, 1:], thr))
        for fill in (-10.0, 10.0):
            x = torch.full((2, 24, 40, 3), fill, dtype=dtype, device="cuda")
            err = max(err, check_k1(f"all {'below' if fill < 0 else 'above'} "
                                    f"{tag}", x, thr))
    for nchw in (False, True):
        serving = planted_logits(g, SERVE_BATCH, 512, 512, 3, torch.bfloat16, nchw)
        err = max(err, check_k1(f"serving shape {'NCHW view' if nchw else 'NHWC'} "
                                f"bf16", serving, thr))
    return err


# -- phases 4-6: the main path -----------------------------------------------


def grid_boxes(mask):
    """Inclusive boxes of (B,S,S,3) bool masks on the grid, as the fixture's."""
    b, v = bbox_from_probs(mask.to(torch.float32), [0.5, 0.5, 0.5])
    return b.cpu().numpy(), v.cpu().numpy()


def phase_fp32(fix):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("  TF32 off: torch.backends.cudnn.allow_tf32 = "
          "torch.backends.cuda.matmul.allow_tf32 = False", flush=True)
    seg = load_pretrained_segmenter("w16", dtype=torch.float32)
    pages = fix["pages"]
    rgb = np.repeat(pages[..., None], 3, axis=-1)
    mask, boxes, ok = seg.segment_batch(rgb, pre_resized=False)
    boxes, ok = boxes.cpu().numpy(), ok.cpu().numpy()
    gboxes, gvalid = grid_boxes(mask)
    if not np.array_equal(ok, fix["ok"]):
        raise AssertionError(f"fp32 ok flags {ok.tolist()} != JAX {fix['ok'].tolist()}")
    if not np.array_equal(gvalid, fix["grid_valid"]):
        raise AssertionError(f"fp32 valid flags {gvalid.tolist()} != JAX "
                             f"{fix['grid_valid'].tolist()}")
    dg = np.abs(gboxes - fix["grid_boxes"])[gvalid]
    if dg.size and dg.max() > 1:
        raise AssertionError(f"fp32 grid boxes off by {dg.max()} cells from JAX:\n"
                             f"{gboxes.tolist()}\nvs\n{fix['grid_boxes'].tolist()}")
    n_crops = 0
    for i, page in enumerate(pages):
        crops = crop_fields(page, boxes[i], ok[i], seg.cfg.black_crop_mean)
        for j, (field, crop) in enumerate(crops.items()):
            if ok[i, j] and crop is None:
                raise AssertionError(f"page {i} {field}: found but no crop")
            if crop is not None:
                x1, y1, x2, y2 = boxes[i, j]
                if crop.shape != (y2 - y1, x2 - x1):
                    raise AssertionError(f"page {i} {field}: crop {crop.shape} "
                                         f"for box {boxes[i, j].tolist()}")
                n_crops += 1
    exact = int((gboxes == fix["grid_boxes"]).all(-1)[gvalid].sum())
    exact_px = int((boxes == fix["boxes"]).all(-1)[ok].sum())
    print(f"  fp32 vs JAX: valid {int(gvalid.sum())}/{gvalid.size} equal; grid "
          f"boxes exactly equal {exact}/{int(gvalid.sum())}, max |d| "
          f"{int(dg.max()) if dg.size else 0} cell; pixel boxes exactly equal "
          f"{exact_px}/{int(ok.sum())}; {n_crops} crops", flush=True)
    return gboxes, gvalid


def phase_bf16(fix, ref):
    gb32, gv32 = ref
    seg = load_pretrained_segmenter("w16", dtype=torch.bfloat16)
    rgb = np.repeat(fix["pages"][..., None], 3, axis=-1)
    mask, _, ok = seg.segment_batch(rgb, pre_resized=False)
    gb, gv = grid_boxes(mask)
    both = gv & gv32
    d = np.abs(gb - gb32)[both]
    print(f"  bf16 vs fp32: valid equal {int((gv == gv32).sum())}/{gv.size}; grid "
          f"boxes exactly equal {int((d == 0).all(-1).sum())}/{int(both.sum())}, "
          f"max |d| {int(d.max()) if d.size else 0} cells", flush=True)
    return seg


def serving_batch(fix, size):
    """The fixture pages resized to the grid on the device, repeated to the
    serving batch: (128, 512, 512, 3) uint8 on the card."""
    raw = torch.as_tensor(fix["pages"], device="cuda")[:, None].expand(-1, 3, -1, -1)
    small = resize_bilinear(raw, size, size).round().clamp(0, 255).to(torch.uint8)
    small = small.permute(0, 2, 3, 1)
    reps = -(-SERVE_BATCH // small.shape[0])
    return small.repeat(reps, 1, 1, 1)[:SERVE_BATCH].contiguous()


def phase_serving(seg, fix, card):
    size = seg.cfg.img_size
    imgs = serving_batch(fix, size)
    h, w = fix["pages"].shape[1:]
    sizes = np.tile(np.asarray([[w, h]], np.int32), (SERVE_BATCH, 1))
    for _ in range(3):
        _, boxes, ok = seg.segment_batch(imgs, sizes, return_masks=False)
        boxes.cpu()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(SERVE_ITERS):
        _, boxes, ok = seg.segment_batch(imgs, sizes, return_masks=False)
        host_boxes = boxes.cpu().numpy()
    dt = time.perf_counter() - t
    ok = ok.cpu().numpy()
    if not ok.all() or host_boxes.shape != (SERVE_BATCH, 3, 4):
        raise AssertionError(f"b{SERVE_BATCH} serving: {int(ok.sum())}/{ok.size} ok")
    ips = SERVE_BATCH * SERVE_ITERS / dt
    print(f"  b{SERVE_BATCH} {size}^2 bf16 box-only, boxes to host each batch: "
          f"{ips:.1f} img/s ({1e3 * dt / SERVE_ITERS:.2f} ms/batch, "
          f"{SERVE_ITERS} batches) [{card}]", flush=True)
    return imgs, 3 + SERVE_ITERS


def time_k1(seg, imgs, thr, card):
    """K1 on the w16 model's own serving logits (NHWC-contiguous: the U-Net
    runs channels-last), and on the same values as an NCHW tensor's view."""
    with torch.inference_mode():
        x = imgs.permute(0, 3, 1, 2).to(seg.dtype) / 255.0
        x = x.contiguous(memory_format=torch.channels_last)
        logits = unet_apply_folded(seg.folded, x).permute(0, 2, 3, 1)
    if not logits.is_contiguous():
        raise AssertionError(f"serving logits strides {logits.stride()}: "
                             f"expected NHWC-contiguous")
    nchw_view = logits.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    check_k1("serving logits of the w16 model", logits, thr)
    check_k1("serving logits as an NCHW view", nchw_view, thr)
    ms = cuda_ms(lambda: k1.bbox_postprocess(logits, thr), iters=50)
    view_ms = cuda_ms(lambda: k1.bbox_postprocess(nchw_view, thr), iters=50)
    plain_ms = cuda_ms(lambda: k1.bbox_postprocess_reference(logits, thr), iters=10)
    b, _, _, c = logits.shape
    n_bytes = logits.numel() * logits.element_size() + b * c * (4 * 4 + 1) + 4 * c
    ops = logits.numel()  # one compare per logit; min/max updates only on hits
    bytes_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / FP32_OPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"  K1 {tuple(logits.shape)} {logits.dtype} NHWC-contiguous: {ms:.4f} ms "
          f"vs bound {bound_ms:.4f} ms ({n_bytes} B at 3.35 TB/s; "
          f"{100 * bound_ms / ms:.1f}% of bound); as an NCHW view {view_ms:.4f} ms; "
          f"plain PyTorch {plain_ms:.4f} ms; no single PyTorch call computes it "
          f"[{card}]", flush=True)
    return ms, plain_ms, bound_ms, bound_by


def main():
    ph = Phases()
    name, card = ph.run(1, "device", phase_device)
    ph.run(2, "build CUDA kernels", phase_build)
    thr = probability_to_logit_thresholds((0.25, 0.40, 0.30))
    max_err = ph.run(3, "K1 vs plain PyTorch on the card", phase_k1, thr)
    with np.load(FIXTURE) as z:
        fix = {k: z[k] for k in z.files}

    _build.launches.clear()  # the main path starts here
    ref = ph.run(4, "w16 fp32 end to end vs JAX", phase_fp32, fix)
    seg = ph.run(5, "w16 bf16 end to end", phase_bf16, fix, ref)
    imgs, serve_calls = ph.run(6, f"b{SERVE_BATCH} bf16 serving",
                               phase_serving, seg, fix, card)
    launches = dict(_build.launches)
    calls = 2 + serve_calls  # segment_batch calls in phases 4-6
    if launches.get(k1.NAME, 0) != calls:
        raise AssertionError(f"K1 launched {launches.get(k1.NAME, 0)} times in "
                             f"{calls} segment_batch calls")
    print(f"  launches on the main path: {launches}; K1 per segment_batch call: "
          f"{launches[k1.NAME] / calls:g}", flush=True)
    ms, plain_ms, bound_ms, bound_by = ph.run(
        7, "K1 timing", time_k1, seg, imgs, thr, card)

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": k1.NAME,
        "route": "cuda",
        "source": "twinvoice_tpu_torch/csrc/bbox_postprocess.cu",
        "replaces": "twinvoice_tpu/ops/pallas/postprocess.py:52",
        "launches": launches[k1.NAME],
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
