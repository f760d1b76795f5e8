"""K3a and K7a against an earlier tree's kernels of the same contract, on one
CUDA card, in one process.

Builds the earlier tree's ``qconv3x3_nhwc_dma.cu`` and ``qconv3x3_pair_dma.cu``
(a copy of its ``twinvoice_tpu_torch/csrc``, e.g. unpacked from
``git archive <commit> twinvoice_tpu_torch/csrc`` into a directory that
``.gitignore`` lists) and times them beside this tree's at the flagship shape
(b128, 512², 64->64; K7a on it packed to phase A) and at the w64 shapes
(K3a at every trunk layer shape, K7a at the "nhwc" trunk's three pair calls),
in turns: earlier, this, this, earlier. Each shape's outputs must be equal
(the two kernels have one contract). Beside them: the bound and the sibling
(K4a for K3a, K7b for K7a) on the same inputs, and the card's name and power
limit. The earlier kernels must take the C interface of the dp4a slab-ring
kernels: four pointers, (N, H, W or P, C, Co, chunk, CW, CoP, in_phase_a),
out_inv, relu, out, stream, the weights as the ``[tap][word][co]`` int32
words of ``ops/nhwc_conv.py:_pack_words``.

    python3 scripts/compare_dma_kernels.py --earlier build/parent/twinvoice_tpu_torch/csrc
        [--batch 128] [--iters 3]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from twinvoice_tpu_torch import _build  # noqa: E402
from twinvoice_tpu_torch.ops import nhwc_conv as nhwc  # noqa: E402
from twinvoice_tpu_torch.ops import qconv  # noqa: E402


def build_earlier(csrc, out_dir):
    """nvcc each earlier source, in parallel. → {kernel name: ctypes function}."""
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = {}
    for name in (nhwc.K3A, nhwc.K7A):
        lib = os.path.join(out_dir, f"{name}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-o", lib, os.path.join(csrc, f"{name}.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=_build.NVCC_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        fn = getattr(ctypes.CDLL(lib), f"twv_{name}")
        ci, cf, vp = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fn.argtypes = [vp] * 4 + [ci] * 9 + [cf, ci, vp, vp]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def run_earlier(fn, x, wts, a, bias, out_scale, shape_args, out_shape, relu=True):
    """One launch of an earlier kernel with its own wrapper's packing: chunks
    of up to 64 channels, the weights as ``[tap][word][co]`` int32 words."""
    c, co = x.shape[3], wts.shape[0]
    chunk = min(-(-c // 16) * 16, 64)
    cpad, cop = -(-c // chunk) * chunk, -(-co // 64) * 64
    words = nhwc._pack_words(wts, cpad, cop)
    out = torch.empty(out_shape, dtype=torch.int8, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(x.data_ptr(), words.data_ptr(), a.data_ptr(), bias.data_ptr(), *shape_args[:4],
             co, chunk, cpad // 4, cop, shape_args[4], float(qconv.out_inv(out_scale)),
             int(relu), out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"earlier kernel launch failed, cudaError {err}")
    return out


def compare(label, earlier, change, sibling, bound, iters, card):
    want = change()
    got = earlier()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: the earlier kernel and this one differ")
    del got, want
    turns = [chip_smoke.cuda_ms(f, iters=iters, warmup=1)
             for f in (earlier, change, change, earlier)]
    sib = chip_smoke.cuda_ms(sibling, iters=iters, warmup=1)
    ms, by = bound
    print(f"  {label}: earlier {turns[0]:.4f} / {turns[3]:.4f} ms, this {turns[1]:.4f} / "
          f"{turns[2]:.4f} ms; bound {ms:.4f} ms ({by}; this at "
          f"{100 * ms / min(turns[1:3]):.1f}%); sibling {sib:.4f} ms [{card}]", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", required=True, help="the earlier tree's csrc directory")
    ap.add_argument("--batch", type=int, default=chip_smoke.SERVE_BATCH)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("compare_dma_kernels: no CUDA device")
    card = chip_smoke.card_line()
    print(card, flush=True)
    _build.build([nhwc.K3A, nhwc.K7A, qconv.NAME, nhwc.NAME])
    fns = build_earlier(args.earlier, os.path.join(_build.build_dir(), "earlier"))
    g = torch.Generator(device="cuda")
    g.manual_seed(10)
    n = args.batch
    for hw, cin, co in chip_smoke.trunk_shapes(base=64)[qconv.K4A]:
        x = chip_smoke.rand_s8(g, (n, hw, hw, cin), 0, 128)
        kern = chip_smoke.rand_s8(g, (co, 3, 3, cin))
        ws, b = chip_smoke.epilogue_operands(g, co)
        a = torch.tensor(np.float32(0.01), device="cuda") * ws
        x_pad = nhwc.pad_nhwc(x)
        compare(f"{nhwc.K3A} b{n} {hw}^2 {cin}->{co}",
                lambda: run_earlier(fns[nhwc.K3A], x_pad, kern, a, b, 3.0,
                                    (n, hw, hw, cin, 0), (n, hw, hw, co)),
                lambda: nhwc.qconv3x3_nhwc_dma(x_pad, kern, a, b, 3.0),
                lambda: qconv.qconv3x3_requant(x, kern, ws, b, 0.01, 3.0),
                chip_smoke.dma_bound_ms(nhwc.K3A, n, hw, cin, co), args.iters, card)
        del x, x_pad
    for label, (_, h, p, cpk, co2), in_phase in chip_smoke.k7b_serving_calls(base=64, n=n):
        x = chip_smoke.rand_s8(g, (n, h, p, cpk), 0, 128)
        wp = chip_smoke.rand_s8(g, (co2, 3, 2, cpk))
        a2, b2 = chip_smoke.epilogue_operands(g, co2)
        p_out = p - 1 if in_phase == "A" else p + 1
        compare(f"{nhwc.K7A} b{n} w64 {label} ({h}, {p}, {cpk} -> {co2})",
                lambda: run_earlier(fns[nhwc.K7A], x, wp, a2, b2, 3.0,
                                    (n, h, p, cpk, int(in_phase == "A")), (n, h, p_out, co2)),
                lambda: nhwc.qconv3x3_pair_dma(x, wp, a2, b2, 3.0, in_phase=in_phase),
                lambda: nhwc.qconv3x3_pair_requant(x, wp, a2, b2, 3.0, in_phase=in_phase),
                chip_smoke.k7b_bound_ms(n, h, p, cpk, co2, in_phase), args.iters, card)
        del x
    return 0


if __name__ == "__main__":
    sys.exit(main())
