"""Pair-packed int8 3×3 convolutions (W-phase layouts) and K7b.

Ports of ``twinvoice_tpu/ops/nhwc_conv.py``: the pair packing of weights
(``pack_w_pair_multi``, ``pack_w_pair``), the phase views (``to_phase_a``,
``from_phase_b``) and the Pallas kernel ``qconv3x3_pair_requant`` (K7b), which
one CUDA source (``csrc/qconv3x3_pair.cu``) replaces; its design note is
there.

Phases. A packed tensor ``(B,H,P,2C)`` holds two neighbouring columns of an
NHWC tensor in its channels. Phase B: pair p holds columns (2p, 2p+1), P =
W/2, the same bytes as ``(B,H,W,C)``. Phase A: pair p holds (2p−1, 2p), P =
W/2+1, with one zero column on each side of W baked in. A 3-wide conv maps A
to B and B to A with the same packed weights, so chained convs alternate
phases without a relayout.

Layouts: the JAX packed weight ``(3,2,Cpk,Co2)`` is ``(Co2,3,2,Cpk)`` here,
channels innermost as the port's ``(Co,3,3,Ci)`` kernels; activations are
contiguous int8 tensors. The TPU's row tiling (``th``) is not carried over:
every function takes any H.

``qconv3x3_pair_requant`` launches the kernel for a CUDA tensor and takes its
plain version only for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from twinvoice_tpu_torch import _build
from twinvoice_tpu_torch.ops.qconv import out_inv, requant

NAME = "qconv3x3_pair"
K7B = "qconv3x3_pair_requant"  # launch-count key


def pack_w_pair_multi(blocks):
    """Pair weights for an input that is a channel concat of packed sources
    (the decoder's ``[up(2p)|up(2p+1)|skip(2p)|skip(2p+1)]``).

    ``blocks``: one (Co,3,3,Ci) int8 kernel per packed source, in channel
    order → (2Co,3,2,2ΣCi). View v=0 is the input pair at the output pair's
    own index, v=1 the next (``nhwc_conv.py:260``):
    output phase lo: v0lo→k0, v0hi→k1, v1lo→k2; phase hi: v0hi→k0, v1lo→k1,
    v1hi→k2.
    """
    co = blocks[0].shape[0]
    ci_tot = sum(k.shape[3] for k in blocks)
    wp = blocks[0].new_zeros((2 * co, 3, 2, 2 * ci_tot))
    ofs = 0
    for k in blocks:
        ci = k.shape[3]
        lo, hi = slice(ofs, ofs + ci), slice(ofs + ci, ofs + 2 * ci)
        wp[:co, :, 0, lo] = k[:, :, 0]
        wp[:co, :, 0, hi] = k[:, :, 1]
        wp[co:, :, 0, hi] = k[:, :, 0]
        wp[:co, :, 1, lo] = k[:, :, 2]
        wp[co:, :, 1, lo] = k[:, :, 1]
        wp[co:, :, 1, hi] = k[:, :, 2]
        ofs += 2 * ci
    return wp


def pack_w_pair(kernel):
    """Single-source :func:`pack_w_pair_multi`: (Co,3,3,Ci) → (2Co,3,2,2Ci)."""
    return pack_w_pair_multi([kernel])


def to_phase_a(x):
    """NHWC (B,H,W,C) → phase-A packed (B,H,W/2+1,2C): one zero column on
    each side of W, viewed as pairs (a pad and a view)."""
    b, h, w, c = x.shape
    return F.pad(x, (0, 0, 1, 1)).view(b, h, (w + 2) // 2, 2 * c)


def from_phase_b(t):
    """Phase-B packed (B,H,P,2C) → NHWC (B,H,2P,C), a view."""
    b, h, p, c2 = t.shape
    return t.view(b, h, 2 * p, c2 // 2)


def _p_out(p_in, in_phase):
    if in_phase not in ("A", "B"):
        raise ValueError(f"in_phase must be 'A' or 'B', got {in_phase!r}")
    if p_in % 2 != (1 if in_phase == "A" else 0):
        raise ValueError(f"{K7B}: {p_in} pairs is not a phase-{in_phase} width "
                         f"(phase A has an odd count, phase B an even one)")
    return p_in - 1 if in_phase == "A" else p_in + 1


def _zero_pad_pairs(q, in_phase):
    """Zero the baked-in W pad of a phase-A output (B→A): the lower half of
    pair 0 and the upper half of the last pair (``nhwc_conv.py:530-538``)."""
    if in_phase == "B":
        half = q.shape[-1] // 2
        q[:, :, 0, :half] = 0
        q[:, :, -1, half:] = 0
    return q


def pair_conv_i8(x, wp, in_phase="A"):
    """K7b's sums: (B,H,P,Cpk) int8 × (Co2,3,2,Cpk) int8 → (B,H,P∓1,Co2)
    float64, exact. A conv over the pair tensor with H padded by one row on
    each side, and W by one pair on each side for a B input (δ = −1)."""
    p_out = _p_out(x.shape[2], in_phase)
    pad_w = 0 if in_phase == "A" else 1
    xf = x.permute(0, 3, 1, 2).to(torch.float64)
    kf = wp.permute(0, 3, 1, 2).to(torch.float64)  # (Co2, Cpk, 3, 2)
    acc = F.conv2d(xf, kf, padding=(1, pad_w)).permute(0, 2, 3, 1)
    assert acc.shape[2] == p_out
    return acc


def qconv3x3_pair_requant_reference(x, wp, a2, bias2, out_scale, *, in_phase="A",
                                    relu=True):
    """Plain version of :func:`qconv3x3_pair_requant`: the exact sums, the
    float32 epilogue (one rounding a step), the pad zeroing."""
    y = pair_conv_i8(x, wp, in_phase).to(torch.float32) * a2 + bias2
    return _zero_pad_pairs(requant(y, out_scale, relu).contiguous(), in_phase)


def _library():
    fn = _build.library(NAME).twv_qconv3x3_pair_requant
    if fn.argtypes is None:
        ci, cf, vp = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, cf, ci, vp, vp]
        fn.restype = ctypes.c_int
    return fn


def _check(x, wp, a2, bias2):
    if x.device.type != "cuda":
        raise ValueError(f"{K7B}: no kernel for {x.device}")
    for t, what, dtype in ((x, "x", torch.int8), (wp, "wp", torch.int8),
                           (a2, "a2", torch.float32), (bias2, "bias2", torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{K7B}: {what} on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{K7B}: {what} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{K7B}: {what} must be contiguous")
    if x.dim() != 4 or min(x.shape) == 0:
        raise ValueError(f"{K7B}: x must be a non-empty (B,H,P,Cpk), got "
                         f"{tuple(x.shape)}")
    co2 = wp.shape[0]
    if wp.shape != (co2, 3, 2, x.shape[3]) or co2 == 0 or co2 % 2:
        raise ValueError(f"{K7B}: wp {tuple(wp.shape)} for x {tuple(x.shape)}; "
                         f"expected (Co2,3,2,Cpk) with Co2 even")
    if a2.shape != (co2,) or bias2.shape != (co2,):
        raise ValueError(f"{K7B}: a2 {tuple(a2.shape)} and bias2 "
                         f"{tuple(bias2.shape)} for {co2} output channels")


def qconv3x3_pair_requant(x, wp, a2, bias2, out_scale, *, in_phase="A", relu=True):
    """K7b: pair-packed int8 3×3 SAME conv → float32 epilogue → int8, A→B or
    B→A.

    ``x``: (B,H,P,Cpk) int8 contiguous, phase ``in_phase`` (P odd for A, even
    for B), H unpadded; ``wp``: (Co2,3,2,Cpk) int8, any packing; ``a2``,
    ``bias2``: (Co2,) float32; ``out_scale``: a host float. With δ = 0 for an
    A input and −1 for a B input, ``acc[b,h,q,o] = Σ_{dy,v,c} x[b,h+dy−1,
    q+v+δ,c]·wp[o,dy,v,c]`` (rows and pairs outside read zero), ``y =
    acc·a2[o] + bias2[o]``, then ReLU where asked and ``clip(round(y·127/
    out_scale))`` to [0,127] or [−127,127]. → (B,H,P∓1,Co2) int8 in the other
    phase; a B→A output has its pad half-pairs zero.
    """
    if x.device.type == "cpu":
        return qconv3x3_pair_requant_reference(x, wp, a2, bias2, out_scale,
                                               in_phase=in_phase, relu=relu)
    p_out = _p_out(x.shape[2], in_phase)
    _check(x, wp, a2, bias2)
    n, h, p_in, cpk = x.shape
    co2 = wp.shape[0]
    out = torch.empty((n, h, p_out, co2), dtype=torch.int8, device=x.device)
    fn = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), wp.data_ptr(), a2.data_ptr(), bias2.data_ptr(), n, h,
                 p_in, cpk, co2, int(in_phase == "A"), float(out_inv(out_scale)),
                 int(bool(relu)), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{K7B}: kernel launch failed, cudaError {err}")
    _build.launches[K7B] += 1
    return out
