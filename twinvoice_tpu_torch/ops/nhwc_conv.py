"""Int8 3×3 convolutions of caller-padded NHWC and pair-packed (W-phase)
tensors: K3a, K3b, K7a and K7b.

Ports of ``twinvoice_tpu/ops/nhwc_conv.py``: the pair packing of weights
(``pack_w_pair_multi``, ``pack_w_pair``), the phase views (``to_phase_a``,
``from_phase_b``), ``pad_nhwc``, and its four Pallas kernels, each replaced by
a CUDA source of its own whose design note is at its head:

- ``qconv3x3_nhwc_requant`` (K3b, ``csrc/qconv3x3_nhwc_requant.cu``) and
  ``qconv3x3_nhwc_dma`` (K3a, ``csrc/qconv3x3_nhwc_dma.cu``): K4a's conv on an
  input the caller padded with :func:`pad_nhwc`. K3b drops the two H-pad rows
  and convolves zero rows in their place; K3a reads every row of the padded
  input. Both read the W-pad columns as they lie;
- ``qconv3x3_pair_requant`` (K7b, ``csrc/qconv3x3_pair.cu``, on the int8
  tensor cores: K4a's implicit GEMM over a 3×2 window, its launch plan from
  :func:`pair_plan`) and ``qconv3x3_pair_dma`` (K7a,
  ``csrc/qconv3x3_pair_dma.cu``): the pair-packed conv, A→B or B→A.

Phases. A packed tensor ``(B,H,P,2C)`` holds two neighbouring columns of an
NHWC tensor in its channels. Phase B: pair p holds columns (2p, 2p+1), P =
W/2, the same bytes as ``(B,H,W,C)``. Phase A: pair p holds (2p−1, 2p), P =
W/2+1, with one zero column on each side of W baked in. A 3-wide conv maps A
to B and B to A with the same packed weights, so chained convs alternate
phases without a relayout.

Layouts: the JAX weights ``(3,3,C,Co)`` and ``(3,2,Cpk,Co2)`` are
``(Co,3,3,C)`` and ``(Co2,3,2,Cpk)`` here, channels innermost as the port's
other kernels; activations are contiguous int8 tensors. The TPU's row tiling
(``th``) is not carried over: every function takes any H.

The epilogue of all four is ``y = fma(acc, a, bias)`` (one rounding, as XLA
fuses the JAX kernels' ``acc·a + b`` under ``jit``), then ReLU where asked and
``clip(round(y·127/out_scale))`` to [0,127] or [−127,127]. Each wrapper
launches its kernel for a CUDA tensor and takes its plain version only for a
CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from twinvoice_tpu_torch import _build
from twinvoice_tpu_torch.ops.qconv import (
    H100_SMS,
    ConvPlan,
    _sm_count,
    check_operands,
    conv_plan,
    fma32,
    out_inv,
    requant,
)

NAME = "qconv3x3_pair"  # K7b's library
# launch-count keys; K3a's, K3b's and K7a's are also their libraries' names
K7B = "qconv3x3_pair_requant"
K7A = "qconv3x3_pair_dma"
K3A = "qconv3x3_nhwc_dma"
K3B = "qconv3x3_nhwc_requant"


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
    float32 epilogue ``fma(acc, a2, bias2)``, the pad zeroing."""
    y = fma32(pair_conv_i8(x, wp, in_phase).to(torch.float32), a2, bias2)
    return _zero_pad_pairs(requant(y, out_scale, relu).contiguous(), in_phase)


def pair_plan(n, h, p_in, cpk, co2, in_phase="A", *, sms=H100_SMS) -> ConvPlan:
    """The launch plan of ``csrc/qconv3x3_pair.cu`` for a (n,h,p_in,cpk) →
    co2 pair conv: K4a's plan (``ops/qconv.py:conv_plan``) for the 3×2 window
    over the pair tensor, whose output is ``p_in ∓ 1`` pairs wide. Cpk ≤ 4 puts
    all six taps in one 32-byte k step, Cpk ≤ 16 two a step (3 steps); its k
    order is ``qconv.k_slots(plan, cpk, kw=2)``, taps ``2·dy + v``."""
    return conv_plan(n, h, _p_out(p_in, in_phase), cpk, co2, sms=sms, kw=2)


def _library():
    fn = _build.library(NAME).twv_qconv3x3_pair_requant
    if fn.argtypes is None:
        ci, cf, vp = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, cf, ci,
                       ci, ci, ci, ci, ci, ci, vp, vp]
        fn.restype = ctypes.c_int
    return fn


def _check(name, x, wp, a2, bias2):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    for t, what, dtype in ((x, "x", torch.int8), (wp, "wp", torch.int8),
                           (a2, "a2", torch.float32), (bias2, "bias2", torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{name}: {what} on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if x.dim() != 4 or min(x.shape) == 0:
        raise ValueError(f"{name}: x must be a non-empty (B,H,P,Cpk), got "
                         f"{tuple(x.shape)}")
    co2 = wp.shape[0]
    if wp.shape != (co2, 3, 2, x.shape[3]) or co2 == 0 or co2 % 2:
        raise ValueError(f"{name}: wp {tuple(wp.shape)} for x {tuple(x.shape)}; "
                         f"expected (Co2,3,2,Cpk) with Co2 even")
    if a2.shape != (co2,) or bias2.shape != (co2,):
        raise ValueError(f"{name}: a2 {tuple(a2.shape)} and bias2 "
                         f"{tuple(bias2.shape)} for {co2} output channels")


def qconv3x3_pair_requant(x, wp, a2, bias2, out_scale, *, in_phase="A", relu=True):
    """K7b: pair-packed int8 3×3 SAME conv → float32 epilogue → int8, A→B or
    B→A.

    ``x``: (B,H,P,Cpk) int8 contiguous, phase ``in_phase`` (P odd for A, even
    for B), H unpadded; ``wp``: (Co2,3,2,Cpk) int8, any packing; ``a2``,
    ``bias2``: (Co2,) float32; ``out_scale``: a host float. With δ = 0 for an
    A input and −1 for a B input, ``acc[b,h,q,o] = Σ_{dy,v,c} x[b,h+dy−1,
    q+v+δ,c]·wp[o,dy,v,c]`` (rows and pairs outside read zero), ``y =
    fma(acc, a2[o], bias2[o])`` (one rounding, as XLA fuses JAX's kernel),
    then ReLU where asked and ``clip(round(y·127/out_scale))`` to [0,127] or
    [−127,127]. → (B,H,P∓1,Co2) int8 in the other
    phase; a B→A output has its pad half-pairs zero.
    """
    if x.device.type == "cpu":
        return qconv3x3_pair_requant_reference(x, wp, a2, bias2, out_scale,
                                               in_phase=in_phase, relu=relu)
    _p_out(x.shape[2], in_phase)
    _check(K7B, x, wp, a2, bias2)
    return _launch_pair(x, wp, a2, bias2, out_scale, in_phase, relu)


def _launch_pair(x, wp, a2, bias2, out_scale, in_phase, relu, out=None):
    """Launch K7b on checked operands into ``out`` (a new tensor by default)."""
    n, h, p_in, cpk = x.shape
    co2 = wp.shape[0]
    if out is None:
        out = torch.empty((n, h, _p_out(p_in, in_phase), co2), dtype=torch.int8,
                          device=x.device)
    plan = pair_plan(n, h, p_in, cpk, co2, in_phase, sms=_sm_count(x.device.index or 0))
    fn = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), wp.data_ptr(), a2.data_ptr(), bias2.data_ptr(), n, h,
                 p_in, cpk, co2, int(in_phase == "A"), float(out_inv(out_scale)),
                 int(bool(relu)), plan.layout, plan.cc, plan.nt, plan.stages, plan.smem,
                 plan.grid[0], out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{K7B}: kernel launch failed, cudaError {err}")
    _build.launches[K7B] += 1
    return out


# -- K3a, K3b, K7a ------------------------------------------------------------------


def pad_nhwc(x):
    """Zero-pad H and W of an NHWC tensor by one each side (the conv's SAME
    halo): (B,H,W,C) → (B,H+2,W+2,C), contiguous."""
    return F.pad(x, (0, 0, 1, 1, 1, 1)).contiguous()


def nhwc_conv_i8(x_pad, kernel, *, drop_h_pad):
    """The sums of K3a (``drop_h_pad=False``: every row of ``x_pad``) and K3b
    (``True``: the two H-pad rows read as zeros): (B,H+2,W+2,C) int8 ×
    (Co,3,3,C) int8 → (B,H,W,Co) float64, exact."""
    xs = x_pad[:, 1:-1] if drop_h_pad else x_pad
    xf = xs.permute(0, 3, 1, 2).to(torch.float64)
    kf = kernel.permute(0, 3, 1, 2).to(torch.float64)
    return F.conv2d(xf, kf, padding=(1 if drop_h_pad else 0, 0)).permute(0, 2, 3, 1)


def qconv3x3_nhwc_requant_reference(x_pad, kernel, a, bias, out_scale, *, relu=True):
    """Plain version of :func:`qconv3x3_nhwc_requant`."""
    y = fma32(nhwc_conv_i8(x_pad, kernel, drop_h_pad=True).to(torch.float32), a, bias)
    return requant(y, out_scale, relu).contiguous()


def qconv3x3_nhwc_dma_reference(x_pad, kernel, a, bias, out_scale, *, relu=True):
    """Plain version of :func:`qconv3x3_nhwc_dma`."""
    y = fma32(nhwc_conv_i8(x_pad, kernel, drop_h_pad=False).to(torch.float32), a, bias)
    return requant(y, out_scale, relu).contiguous()


def _round_up(v, m):
    return -(-v // m) * m


def _pack_words(kernel, cpad, cop):
    """A (Co,kh,kw,C) int8 kernel → the ``[tap][word][co]`` int32 words K3a,
    K3b and K7a read: word q of tap t for output channel o holds channels
    4q..4q+3, little-endian; zeros past C (up to ``cpad``) and past Co (up to
    ``cop``)."""
    co, c = kernel.shape[0], kernel.shape[-1]
    k = F.pad(kernel.reshape(co, -1, c), (0, cpad - c)).contiguous()
    words = k.view(torch.int32).permute(1, 2, 0)  # (taps, cpad/4, co)
    return F.pad(words, (0, cop - co)).contiguous()


def _kernel_fn(name):
    """K3b's, K3a's and K7a's C functions share one signature: four pointers,
    (N, H, W, C, Co, chunk, CW, CoP, in_phase_a), out_inv, relu, out, stream."""
    fn = getattr(_build.library(name), f"twv_{name}")
    if fn.argtypes is None:
        ci, cf, vp = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fn.argtypes = [vp] * 4 + [ci] * 9 + [cf, ci, vp, vp]
        fn.restype = ctypes.c_int
    return fn


def _run(name, args, out, x, wpk, a, bias, out_scale, relu):
    fn = _kernel_fn(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), wpk.data_ptr(), a.data_ptr(), bias.data_ptr(), *args,
                 float(out_inv(out_scale)), int(bool(relu)), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {err}")
    _build.launches[name] += 1
    return out


def _check_nhwc(name, x_pad, kernel, a, bias):
    co = check_operands(name, x_pad, kernel, a, bias, 3, scale_name="a")
    if x_pad.shape[1] < 3 or x_pad.shape[2] < 3:
        raise ValueError(f"{name}: x_pad {tuple(x_pad.shape)} is not a padded "
                         f"(B,H+2,W+2,C) with H, W >= 1")
    return co


def qconv3x3_nhwc_requant(x_pad, kernel, a, bias, out_scale, *, relu=True):
    """K3b: int8 3×3 conv of a caller-padded NHWC input → float32 epilogue →
    int8, the rolling-carry kernel's contract.

    ``x_pad``: (B,H+2,W+2,C) int8 contiguous, padded by the caller
    (:func:`pad_nhwc`); ``kernel``: (Co,3,3,C) int8; ``a``: (Co,) float32
    ``s_in·w_scale``; ``bias``: (Co,) float32; ``out_scale``: a host float.
    The two H-pad rows are not read: zero rows take their place (JAX's
    ``x_pad[:, 1:-1]``), while the W-pad columns are read as they lie. →
    (B,H,W,Co) int8, ``acc[b,h,w,o] = Σ x_pad[b,h+dy,w+dx,c]·kernel[o,dy,dx,c]``
    with ``y = fma(acc, a, bias)`` (module doc).
    """
    if x_pad.device.type == "cpu":
        return qconv3x3_nhwc_requant_reference(x_pad, kernel, a, bias, out_scale,
                                               relu=relu)
    co = _check_nhwc(K3B, x_pad, kernel, a, bias)
    n, hp, wp, c = x_pad.shape
    cpad, cop = _round_up(c, 16), _round_up(co, 64)
    out = torch.empty((n, hp - 2, wp - 2, co), dtype=torch.int8, device=x_pad.device)
    return _run(K3B, (n, hp - 2, wp - 2, c, co, 0, cpad // 4, cop, 0), out, x_pad,
                _pack_words(kernel, cpad, cop), a, bias, out_scale, relu)


def qconv3x3_nhwc_dma(x_pad, kernel, a, bias, out_scale, *, relu=True):
    """K3a: as :func:`qconv3x3_nhwc_requant`, but every row of ``x_pad`` is
    read, its H-pad rows included (the DMA-ring kernel's contract): with zero
    pad rows the two agree, with others each follows its JAX kernel. →
    (B,H,W,Co) int8, ``acc[b,h,w,o] = Σ x_pad[b,h+dy,w+dx,c]·kernel[o,dy,dx,c]``.
    """
    if x_pad.device.type == "cpu":
        return qconv3x3_nhwc_dma_reference(x_pad, kernel, a, bias, out_scale, relu=relu)
    co = _check_nhwc(K3A, x_pad, kernel, a, bias)
    n, hp, wp, c = x_pad.shape
    chunk = min(_round_up(c, 16), 64)
    cpad, cop = _round_up(c, chunk), _round_up(co, 64)
    out = torch.empty((n, hp - 2, wp - 2, co), dtype=torch.int8, device=x_pad.device)
    return _run(K3A, (n, hp - 2, wp - 2, c, co, chunk, cpad // 4, cop, 0), out, x_pad,
                _pack_words(kernel, cpad, cop), a, bias, out_scale, relu)


def qconv3x3_pair_dma(x, wp, a2, bias2, out_scale, *, in_phase="A", relu=True):
    """K7a: the DMA-ring kernel of :func:`qconv3x3_pair_requant`'s contract
    (the same arguments and result, A→B or B→A), a CUDA kernel of its own
    (``csrc/qconv3x3_pair_dma.cu``). Its plain version is K7b's,
    :func:`qconv3x3_pair_requant_reference`."""
    if x.device.type == "cpu":
        return qconv3x3_pair_requant_reference(x, wp, a2, bias2, out_scale,
                                               in_phase=in_phase, relu=relu)
    p_out = _p_out(x.shape[2], in_phase)
    _check(K7A, x, wp, a2, bias2)
    n, h, p_in, cpk = x.shape
    co2 = wp.shape[0]
    chunk = min(_round_up(cpk, 16), 64)
    cpad, cop = _round_up(cpk, chunk), _round_up(co2, 64)
    out = torch.empty((n, h, p_out, co2), dtype=torch.int8, device=x.device)
    return _run(K7A, (n, h, p_in, cpk, co2, chunk, cpad // 4, cop, int(in_phase == "A")),
                out, x, _pack_words(wp, cpad, cop), a2, bias2, out_scale, relu)
