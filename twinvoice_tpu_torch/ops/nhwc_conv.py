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
  input. Both read the W-pad columns as they lie. Both run on the int8 tensor
  cores fed by TMA (``csrc/int8_tma_conv.cuh``, their launch plan from
  :func:`dma_plan`), as K4b does (``ops/qconv.py:qconv3x3_requant_dma``,
  launched by :func:`_launch_dma`);
- ``qconv3x3_pair_requant`` (K7b, ``csrc/qconv3x3_pair.cu``, on the int8
  tensor cores: K4a's implicit GEMM over a 3×2 window, its launch plan from
  :func:`pair_plan`) and ``qconv3x3_pair_dma`` (K7a,
  ``csrc/qconv3x3_pair_dma.cu``, K3a's TMA-fed kernel over a 3×2 window, its
  plan from :func:`dma_plan`): the pair-packed conv, A→B or B→A.

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
from typing import NamedTuple

import torch
import torch.nn.functional as F

from twinvoice_tpu_torch import _build
from twinvoice_tpu_torch.ops.qconv import (
    H100_SMS,
    K4B,
    SMEM_LIMIT,
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
# (K3a, K3b, K4b and K7a also count each launch under "<key>:tma" or
# "<key>:copy", by how the slabs reached shared memory)
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
    out = torch.empty((n, hp - 2, wp - 2, co), dtype=torch.int8, device=x_pad.device)
    return _launch_dma(K3B, x_pad, kernel, a, bias, out_scale, relu, out)


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
    out = torch.empty((n, hp - 2, wp - 2, co), dtype=torch.int8, device=x_pad.device)
    return _launch_dma(K3A, x_pad, kernel, a, bias, out_scale, relu, out)


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
    n, h, _, _ = x.shape
    out = torch.empty((n, h, p_out, wp.shape[0]), dtype=torch.int8, device=x.device)
    return _launch_dma(K7A, x, wp, a2, bias2, out_scale, relu, out, in_phase=in_phase)


# -- K3a, K3b, K4b and K7a: the TMA-fed tensor-core kernel and its plan -------------

DMA_TW = 64           # output columns of a tile (one wgmma m tile)
DMA_ALIGN = 128       # alignment of the ring slots, resident weights and staging
DMA_BOX_MAX = 256     # elements of a tensor map's box along one dimension
GRANULE = 16          # bytes of the input box's inner dimension


def dma_tile_rows(cot: int) -> int:
    """Output rows of a tile of the TMA kernel: two warpgroups of ``256 /
    cot`` rows, each row a 64 × ``cot`` s32 tile (128 registers a thread)."""
    return 2 * (256 // cot)


def dma_cot(co: int) -> int:
    """Output channels a block (the wgmma's N): 32, 64 or 128."""
    return 32 if co <= 32 else 64 if co <= 64 else 128


class DmaPlan(NamedTuple):
    kw: int           # window columns: 3 (K3a, K3b, K4b) or 2 (K7a)
    cot: int          # output channels a block
    th: int           # output rows of a tile (64 columns wide)
    chunk: int        # input channels of a ring item (16, 32, 64 or 128)
    n_chunks: int     # items a tile
    kb: int           # weight bytes of one tap a chunk: max(chunk, 32)
    stages: int       # slots of the ring
    resident: bool    # all the block's weights stay in shared memory
    tma_in: bool      # the slabs come by TMA (else the producer warp copies them)
    tma_out: bool     # the tiles leave by a TMA store (else by bytes)
    slab_bytes: int   # one item's slab: chunk / 16 granule planes
    wchunk_bytes: int  # one item's weights for a block
    smem: int         # bytes of dynamic shared memory a block
    tiles: int        # output tiles of the batch
    grid: tuple       # (blocks along the tiles, blocks along the output channels)


def tensor_map_legal(dims, strides, box, *, base_aligned, swizzle=0, elem_bytes=1) -> bool:
    """Whether ``cuTensorMapEncodeTiled`` takes a map: rank 1–5, every global
    stride (of dimensions 1..) a multiple of 16 bytes under 2^40, a 16-byte
    aligned base, every box dimension 1–256, the inner box a multiple of 16
    bytes and, with a swizzle of ``swizzle`` bytes, no wider than it."""
    inner = box[0] * elem_bytes
    return (1 <= len(dims) <= 5 and len(strides) == len(dims) - 1 == len(box) - 1
            and all(1 <= d < 2**32 for d in dims)
            and all(s % 16 == 0 and 0 < s < 2**40 for s in strides)
            and base_aligned and all(1 <= b <= DMA_BOX_MAX for b in box)
            and inner % 16 == 0 and (swizzle == 0 or inner <= swizzle))


def in_map_geometry(n, hin, win, c, kw, cot, chunk, himg=None):
    """The input's 5-D tensor map: dims (16 bytes, Win, Hin, C/16, N) with
    byte strides (C, Win·C, 16, Himg·Win·C), and the box of one ring item
    (16, 64 + kw − 1, th + 2, chunk/16, 1). ``hin`` rows of an image are
    visible to the map, its images lie ``himg`` rows apart (default
    ``hin``; K3b's ``hin + 2``). → (dims, strides, box)."""
    himg = hin if himg is None else himg
    return ((GRANULE, win, hin, c // GRANULE, n),
            (c, win * c, GRANULE, himg * win * c),
            (GRANULE, DMA_TW + kw - 1, dma_tile_rows(cot) + 2, chunk // GRANULE, 1))


def out_map_geometry(n, h, w, co, cot):
    """The output's 4-D tensor map: dims (Co, W, H, N), byte strides (Co,
    W·Co, H·W·Co), box (cot, 64, th / 2, 1): one warpgroup's rows. →
    (dims, strides, box)."""
    return ((co, w, h, n), (co, w * co, h * w * co),
            (cot, DMA_TW, dma_tile_rows(cot) // 2, 1))


def _dma_smem(kw, cot, chunk, n_chunks, stages, resident) -> int:
    """Bytes of a block's dynamic shared memory (``csrc/int8_tma_conv.cuh:
    plan_smem``): alignment slack, the ring (slab, and the weights when they
    stream), the resident weights, the staging tile, the epilogue factors,
    the mbarriers (a full and an empty one a slot, the weights', two turns)."""
    th = dma_tile_rows(cot)
    slab = chunk // GRANULE * (th + 2) * (DMA_TW + kw - 1) * GRANULE
    wchunk = 3 * kw * max(chunk, 32) * cot
    slot = _round_up(slab + (0 if resident else wchunk), DMA_ALIGN)
    wres = _round_up(n_chunks * wchunk, DMA_ALIGN) if resident else 0
    return (DMA_ALIGN + stages * slot + wres + th * DMA_TW * cot + 8 * cot
            + 8 * (2 * stages + 3))


def dma_plan(n, hin, win, c, h, w, co, kw, *, himg=None, x_aligned=True,
             out_aligned=True, sms=H100_SMS) -> DmaPlan:
    """The launch plan of ``csrc/int8_tma_conv.cuh`` for an input of ``n``
    images of ``hin`` visible rows of ``win`` pixels of ``c`` channels,
    ``himg`` rows apart (default ``hin``), → (n, h, w, co): K3a (``kw=3``,
    the padded (n, h+2, w+2, c) input), K3b (``kw=3``, its rows 1..h, ``himg``
    h + 2), K4b (``kw=3``, the unpadded (n, h, w, c) input) or K7a (``kw=2``,
    the pair tensor (n, h, P, Cpk) → P∓1 pairs). ``x_aligned``: the first
    visible row is 16-byte aligned.

    ``cot`` output channels a block (32, 64, 128), tiles of ``th`` × 64
    output pixels. The weights are resident when they fit beside a ring of 2
    slots, else each item's chunk streams in its slot; the chunk is the widest
    of 128, 64, 32, 16 (not past C rounded up to 16) that fits, with the most
    slots of 4, 3, 2. The slabs come by TMA where the input's tensor map is
    legal (C % 16 == 0, x 16-byte aligned), the tiles leave by TMA where the
    output's is (Co % 16 == 0, out aligned) and the box is no wider than Co.
    The grid is persistent: one block an SM, no more than tiles."""
    cot = dma_cot(co)
    th = dma_tile_rows(cot)
    cmax = _round_up(c, GRANULE)
    chunks = [ch for ch in (128, 64, 32, 16) if ch <= cmax]
    resident, chunk, stages = next(
        (res, ch, st) for res in (True, False) for ch in chunks for st in (4, 3, 2)
        if _dma_smem(kw, cot, ch, -(-c // ch), st, res) <= SMEM_LIMIT)
    smem = _dma_smem(kw, cot, chunk, -(-c // chunk), stages, resident)
    tma_in = tensor_map_legal(*in_map_geometry(n, hin, win, c, kw, cot, chunk, himg),
                              base_aligned=x_aligned)
    tma_out = cot <= co and tensor_map_legal(*out_map_geometry(n, h, w, co, cot),
                                             base_aligned=out_aligned)
    n_co = -(-co // cot)
    tiles = n * -(-h // th) * -(-w // DMA_TW)
    blocks = max(1, min(tiles, sms // n_co))
    slab = chunk // GRANULE * (th + 2) * (DMA_TW + kw - 1) * GRANULE
    return DmaPlan(kw, cot, th, chunk, -(-c // chunk), max(chunk, 32), stages, resident,
                   tma_in, tma_out, slab, 3 * kw * max(chunk, 32) * cot, smem, tiles,
                   (blocks, n_co))


def dma_channel_order(cot: int):
    """The block's output channel at each wgmma n index: n = 8j + 2q + e (n
    tile j, quad thread q, e of its pair) holds channel q·cot/4 + 2j + e, so
    that thread q of a quad holds cot/4 neighbouring channels of a pixel and
    stores them as whole words. → (cot,) int64."""
    n = torch.arange(cot)
    return (n % 8) // 2 * (cot // 4) + 2 * (n // 8) + n % 2


def pack_dma_weights(kernel, plan: DmaPlan):
    """(Co, 3, kw, C) int8 → the packed weights the TMA kernel reads,
    [co block][chunk][tap][granule][n][16 bytes]: one chunk's weights for a
    block are ``plan.wchunk_bytes`` contiguous bytes, each 8 n indices by 16
    bytes of k one wgmma core matrix, n index n holding the block's channel
    ``dma_channel_order(cot)[n]``; zeros past C (to ``kb`` bytes a tap) and
    past Co. Views, pads and one copy on the weights' device: no index
    tensor, so no host-to-device copy (and no stream synchronisation) a
    call."""
    co, c = kernel.shape[0], kernel.shape[-1]
    taps, n_co, cot = 3 * plan.kw, plan.grid[1], plan.cot
    k = F.pad(kernel.reshape(co, taps, c),
              (0, plan.n_chunks * plan.chunk - c, 0, 0, 0, n_co * cot - co))
    # the block's channel q·cot/4 + 2j + e as (q, j, e); n index 8j + 2q + e
    k = k.view(n_co, 4, cot // 8, 2, taps, plan.n_chunks, plan.chunk)
    if plan.kb > plan.chunk:
        k = F.pad(k, (0, plan.kb - plan.chunk))
    k = k.view(n_co, 4, cot // 8, 2, taps, plan.n_chunks, plan.kb // GRANULE, GRANULE)
    return k.permute(0, 5, 4, 6, 2, 1, 3, 7).reshape(
        n_co, plan.n_chunks, taps, plan.kb // GRANULE, cot, GRANULE)


def _dma_fn(name):
    fn = getattr(_build.library(name), f"twv_{name}")
    if fn.argtypes is None:
        ci, cf, vp = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        n_ints = 14 if name == K7A else 13  # K7a's in_phase_a besides the shape
        fn.argtypes = [vp] * 4 + [ci] * n_ints + [cf, ci, vp, vp]
        fn.restype = ctypes.c_int
    return fn


def _dma_error(err):
    if err == 900:
        return "cuTensorMapEncodeTiled not found"
    if err >= 1000:
        return f"cuTensorMapEncodeTiled refused a tensor map, CUresult {err - 1000}"
    return f"cudaError {err}"


def dma_input(name, shape):
    """What the TMA kernel ``name`` (K3a, K3b, K4b or K7a) sees of its input
    of ``shape``: → (kw, hin, himg, row0), its window's columns, the visible
    rows of an image, the rows from one image to the next and the first
    visible row. K3b sees rows 1..H of its padded (N, H+2, W+2, C) input, so
    the zero halo comes from TMA and the live pad rows are never read."""
    rows = shape[1]
    if name == K3B:
        return 3, rows - 2, rows, 1
    return (2 if name == K7A else 3), rows, rows, 0


def _launch_dma(name, x, kernel, a, bias, out_scale, relu, out, *, in_phase=None):
    """Plan, pack the weights and launch K3a, K3b, K4b or K7a (``in_phase``
    "A" or "B") on checked operands into ``out``."""
    n, _, win, c = x.shape
    _, h, w, co = out.shape
    kw, hin, himg, row0 = dma_input(name, x.shape)
    plan = dma_plan(n, hin, win, c, h, w, co, kw, himg=himg,
                    x_aligned=(x.data_ptr() + row0 * win * c) % 16 == 0,
                    out_aligned=out.data_ptr() % 16 == 0,
                    sms=_sm_count(x.device.index or 0))
    wpk = pack_dma_weights(kernel, plan)
    shape = (n, hin, win, c, co, int(in_phase == "A")) if kw == 2 else (n, h, w, c, co)
    fn = _dma_fn(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), wpk.data_ptr(), a.data_ptr(), bias.data_ptr(), *shape,
                 plan.cot, plan.chunk, plan.stages, int(plan.resident), int(plan.tma_in),
                 int(plan.tma_out), plan.smem, plan.grid[0], float(out_inv(out_scale)),
                 int(bool(relu)), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, {_dma_error(err)}")
    _build.launches[name] += 1
    _build.launches[f"{name}:{'tma' if plan.tma_in else 'copy'}"] += 1
    return out
