"""Where a serving batch's time goes in the PyTorch port, on one CUDA card.

Runs the bundled w16 segmenter at bf16 (or on an int8 route, with the
activation scales of ``tests/data/torch_smoke_int8.npz``) on a batch of
random uint8 512² images (``bench.py``'s input), box-only, boxes read back
after every batch, under ``torch.profiler``; prints the device time per
kernel and per launching op (top rows), the device busy time (sum of kernel
times) and host wall time per batch, the idle share, and the card's name and
power limit.

    python3 scripts/profile_torch_serving.py [--batch 128] [--iters 5]
        [--int8 xla|xla-bf16|pallas|pallas-trunk|wpack-full|wpack-enc|wpack-nhwc]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from twinvoice_tpu_torch.infer.quant import scales_from_array  # noqa: E402
from twinvoice_tpu_torch.models.pretrained import load_pretrained_segmenter  # noqa: E402

INT8_FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "tests", "data", "torch_smoke_int8.npz")
INT8_ROUTES = {"xla": {"int8_head": "xla"}, "xla-bf16": {"int8_head": "xla-bf16"},
               "pallas": {"int8_head": "pallas"}, "pallas-trunk": {"int8_pallas": True},
               "wpack-full": {"int8_wpack": "full"}, "wpack-enc": {"int8_wpack": "enc"},
               "wpack-nhwc": {"int8_wpack": "nhwc"}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--rows", type=int, default=15, help="kernel rows to print")
    ap.add_argument("--int8", choices=sorted(INT8_ROUTES), default=None,
                    help="profile this int8 route instead of bf16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serving: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]

    if args.int8:
        with np.load(INT8_FIXTURE) as z:
            scales = scales_from_array(z["scales"])
        seg = load_pretrained_segmenter(torch.float32, variant="w16",
                                        int8_scales=scales, **INT8_ROUTES[args.int8])
    else:
        seg = load_pretrained_segmenter(variant="w16", dtype=torch.bfloat16)
    what = f"int8 {args.int8}" if args.int8 else "bf16"
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    size = seg.cfg.img_size
    imgs = torch.randint(0, 255, (args.batch, size, size, 3), generator=g,
                         device="cuda", dtype=torch.uint8)
    sizes = torch.tensor([[1920, 1080]] * args.batch, dtype=torch.int32)

    def step():
        _, boxes, _ = seg.segment_batch(imgs, sizes, return_masks=False)
        return boxes.cpu()

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step()
        wall = (time.perf_counter() - t0) / args.iters

    kernels, ops = [], []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us <= 0:
            continue
        row = (dev_us / args.iters, ev.count // args.iters, ev.key)
        # kernels are device events; the aten ops that launched them are not
        on_device = str(getattr(ev, "device_type", "")).endswith("CUDA")
        (kernels if on_device else ops).append(row)
    kernels.sort(reverse=True)
    ops.sort(reverse=True)
    busy_ms = sum(r[0] for r in kernels) / 1e3
    print(f"card: {card}; torch {torch.__version__}")
    print(f"b{args.batch} {size}^2 {what} box-only, {args.iters} batches profiled: "
          f"host wall {1e3 * wall:.3f} ms/batch ({args.batch / wall:.1f} img/s "
          f"under the profiler), device busy {busy_ms:.3f} ms/batch, idle share "
          f"{max(0.0, 1 - busy_ms / (1e3 * wall)):.3f}")
    for title, rows in (("kernel", kernels), ("op (device time it launched)", ops)):
        print(f"{'ms/batch':>10} {'share':>6} {'calls':>5}  {title}")
        for us, calls, key in rows[:args.rows]:
            print(f"{us / 1e3:10.4f} {us / 1e3 / busy_ms:6.3f} {calls:5d}  {key[:110]}")


if __name__ == "__main__":
    main()
