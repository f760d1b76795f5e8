"""K3b, K4b, K3a and K7a against an earlier tree's kernels of the same
contract, on one CUDA card, in one process.

Builds the earlier tree's ``qconv3x3_nhwc_requant.cu`` (K3b),
``qconv3x3_requant_dma.cu`` (K4b), ``qconv3x3_nhwc_dma.cu`` (K3a) and
``qconv3x3_pair_dma.cu`` (K7a) from a copy of its ``twinvoice_tpu_torch/csrc``
(e.g. unpacked from ``git archive <commit> twinvoice_tpu_torch/csrc`` into a
directory that ``.gitignore`` lists), and times them beside this tree's in
turns, earlier, this, this, earlier: K3b at every w64 trunk layer shape, K4b
at every w64 and w16 trunk layer shape with Cin <= 128 (``chip_smoke.py``
phase 16's shapes), K3a and K7a at the flagship shape (b128, 512², 64->64;
K7a on it packed to phase A). Each shape's outputs must be equal (the two
kernels have one contract). Each turn gives the time of a call (CUDA events
around back-to-back calls) and of its kernel alone (``torch.profiler``).
Beside them: the bound, the sibling (K4a, or K7b for K7a) on the same
inputs, and the card's name and power limit.

The earlier kernels must take these C interfaces: K3b the CUDA-core dp4a
kernel's, four pointers, (N, H, W, C, Co, CW, CoP), out_inv, relu, out,
stream, its weights the ``[tap][word][co]`` int32 words of
:func:`pack_words`; K4b the ``mma.sync`` kernel's, four pointers, (N, H, W,
Cin, Co, Cp, CoP), out_inv, relu, out, stream, its weights the padded
``(CoP, 9, Cp)`` bytes of :func:`pack_padded`; K3a and K7a this tree's (the
TMA kernel's plan and packing, ``ops/nhwc_conv.py``).

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
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from twinvoice_tpu_torch import _build  # noqa: E402
from twinvoice_tpu_torch.ops import nhwc_conv as nhwc  # noqa: E402
from twinvoice_tpu_torch.ops import qconv  # noqa: E402

# the earlier kernels' names, for the profiler
EARLIER_KERNEL = {nhwc.K3B: "qconv3x3_nhwc_requant_kernel",
                  qconv.K4B: "qconv3x3_requant_dma_kernel",
                  nhwc.K3A: chip_smoke.TMA_KERNEL, nhwc.K7A: chip_smoke.TMA_KERNEL}


def pack_words(kernel, cpad, cop):
    """A (Co,3,3,C) int8 kernel → the ``[tap][word][co]`` int32 words the
    dp4a K3b reads: word q of tap t for output channel o holds channels
    4q..4q+3, little-endian; zeros past C (up to ``cpad``) and past Co (up to
    ``cop``)."""
    co, c = kernel.shape[0], kernel.shape[-1]
    k = F.pad(kernel.reshape(co, -1, c), (0, cpad - c)).contiguous()
    words = k.view(torch.int32).permute(1, 2, 0)  # (taps, cpad/4, co)
    return F.pad(words, (0, cop - co)).contiguous()


def pack_padded(kernel, cp, cop):
    """A (Co,3,3,Cin) int8 kernel → the ``(CoP, 9, Cp)`` bytes the
    ``mma.sync`` K4b reads, zeros past Cin and Co."""
    co, cin = kernel.shape[0], kernel.shape[-1]
    return F.pad(kernel.reshape(co, 9, cin), (0, cp - cin, 0, 0, 0, cop - co)).contiguous()


def build_earlier(csrc, out_dir):
    """nvcc each earlier source, in parallel. → {kernel name: ctypes function}."""
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = {}
    for name in EARLIER_KERNEL:
        lib = os.path.join(out_dir, f"{name}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-o", lib, os.path.join(csrc, f"{name}.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    fns = {}
    ci, cf, vp = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=_build.NVCC_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        fn = getattr(ctypes.CDLL(lib), f"twv_{name}")
        n_ints = 7 if name in (nhwc.K3B, qconv.K4B) else 14 if name == nhwc.K7A else 13
        fn.argtypes = [vp] * 4 + [ci] * n_ints + [cf, ci, vp, vp]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def run_earlier(fn, name, x, kernel, a, bias, out_scale, relu=True):
    """One launch of the earlier dp4a K3b (``x`` padded) or ``mma.sync`` K4b
    with its own wrapper's weight packing."""
    n, hin, win, c = x.shape
    co = kernel.shape[0]
    h, w = (hin - 2, win - 2) if name == nhwc.K3B else (hin, win)
    if name == nhwc.K3B:
        cpad, cop = -(-c // 16) * 16, -(-co // 64) * 64
        wpk, dims = pack_words(kernel, cpad, cop), (cpad // 4, cop)
    else:
        tile = 8 if co <= 8 else 16 if co <= 16 else 32 if co <= 32 else 64
        cp, cop = -(-c // 32) * 32, -(-co // tile) * tile
        wpk, dims = pack_padded(kernel, cp, cop), (cp, cop)
    out = torch.empty((n, h, w, co), dtype=torch.int8, device=x.device)
    err = fn(x.data_ptr(), wpk.data_ptr(), a.data_ptr(), bias.data_ptr(), n, h, w, c, co,
             *dims, float(qconv.out_inv(out_scale)), int(relu), out.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier {name}: kernel launch failed, cudaError {err}")
    return out


def through(fn, call):
    """``call()`` with the TMA launcher taking ``fn`` (an earlier library's
    entry of this tree's C interface) for its kernel."""
    saved = nhwc._dma_fn
    nhwc._dma_fn = lambda name: fn
    try:
        return call()
    finally:
        nhwc._dma_fn = saved


def compare(label, name, earlier, change, sibling, sibling_kernel, bound, iters, card):
    want = change()
    got = earlier()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: the earlier kernel and this one differ")
    del got, want
    order = ((earlier, EARLIER_KERNEL[name]), (change, chip_smoke.TMA_KERNEL),
             (change, chip_smoke.TMA_KERNEL), (earlier, EARLIER_KERNEL[name]))
    calls = [chip_smoke.cuda_ms(f, iters=iters, warmup=1) for f, _ in order]
    kernels = [chip_smoke.kernel_ms(f, k, iters=iters) for f, k in order]
    sib = chip_smoke.cuda_ms(sibling, iters=iters, warmup=1)
    sib_k = chip_smoke.kernel_ms(sibling, sibling_kernel, iters=iters)
    ms, by = bound
    print(f"  {label}: earlier {calls[0]:.4f} / {calls[3]:.4f} ms a call, "
          f"{kernels[0]:.4f} / {kernels[3]:.4f} in its kernel; this {calls[1]:.4f} / "
          f"{calls[2]:.4f} ms a call, {kernels[1]:.4f} / {kernels[2]:.4f} in its kernel; "
          f"bound {ms:.4f} ms ({by}; this kernel at {100 * ms / min(kernels[1:3]):.1f}%); "
          f"sibling {sib:.4f} ms a call, {sib_k:.4f} in its kernel [{card}]", flush=True)


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
    _build.build([nhwc.K3B, qconv.K4B, nhwc.K3A, nhwc.K7A, qconv.NAME, nhwc.NAME])
    fns = build_earlier(args.earlier, os.path.join(_build.build_dir(), "earlier"))
    g = torch.Generator(device="cuda")
    g.manual_seed(10)
    n = args.batch
    shapes = [(64, s) for s in chip_smoke.trunk_shapes(base=64)[qconv.K4A]]
    shapes += [(16, s) for s in chip_smoke.trunk_shapes(base=16)[qconv.K4A]
               if s[1] <= qconv.K4B_MAX_CIN]
    for base, (hw, cin, co) in shapes:
        x = chip_smoke.rand_s8(g, (n, hw, hw, cin), 0, 128)
        kern = chip_smoke.rand_s8(g, (co, 3, 3, cin))
        ws, b = chip_smoke.epilogue_operands(g, co)
        a = torch.tensor(np.float32(0.01), device="cuda") * ws
        x_pad = nhwc.pad_nhwc(x) if base == 64 else None
        k4a = lambda: qconv.qconv3x3_requant(x, kern, ws, b, 0.01, 3.0)
        cases = [(nhwc.K3B, x_pad, nhwc.qconv3x3_nhwc_requant)] if base == 64 else []
        if cin <= qconv.K4B_MAX_CIN:
            cases.append((qconv.K4B, x, qconv.qconv3x3_requant_dma))
        if (hw, cin, co) == chip_smoke.FLAGSHIP[1:] and base == 64:
            cases.append((nhwc.K3A, x_pad, nhwc.qconv3x3_nhwc_dma))
        for name, xin, fn in cases:
            if name == nhwc.K3A:
                earlier = lambda: through(fns[name], lambda: fn(xin, kern, a, b, 3.0))
            else:
                earlier = lambda: run_earlier(fns[name], name, xin, kern, a, b, 3.0)
            compare(f"{name} b{n} w{base} {hw}^2 {cin}->{co}", name, earlier,
                    lambda: fn(xin, kern, a, b, 3.0), k4a, chip_smoke.WINDOW_KERNEL,
                    chip_smoke.dma_bound_ms(name, n, hw, cin, co), args.iters, card)
        del x, x_pad
    _, hw, cin, co = chip_smoke.FLAGSHIP
    xa = nhwc.to_phase_a(chip_smoke.rand_s8(g, (n, hw, hw, cin), 0, 128))
    wp = chip_smoke.rand_s8(g, (2 * co, 3, 2, 2 * cin))
    a2, b2 = chip_smoke.epilogue_operands(g, 2 * co)
    k7a = lambda: nhwc.qconv3x3_pair_dma(xa, wp, a2, b2, 3.0)
    compare(f"{nhwc.K7A} b{n} A->B {tuple(xa.shape[1:])}->{2 * co}", nhwc.K7A,
            lambda: through(fns[nhwc.K7A], k7a), k7a,
            lambda: nhwc.qconv3x3_pair_requant(xa, wp, a2, b2, 3.0),
            chip_smoke.WINDOW_KERNEL, chip_smoke.dma_bound_ms(nhwc.K7A, n, hw, cin, co),
            args.iters, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
