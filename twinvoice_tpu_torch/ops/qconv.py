"""int8 convolutions of the quantized U-Net: the plain ops, and K4a/K5.

Ports of the int8 pieces of ``twinvoice_tpu.infer.quant`` (``_conv3x3_i8``,
``_conv_transpose2x2_i8``, ``_requant``, the int8 ``max_pool2``) and of the
Pallas kernels ``ops/qconv_pallas.py:qconv3x3_requant`` (K4a) and
``:qconv3x3_split_requant`` (K5), which one CUDA source
(``csrc/qconv3x3.cu``, on the int8 tensor cores) replaces; its design note is
there. :func:`conv_plan` computes the launch plan the kernel is given (k
layout, Cin chunk, output-channel tile, shared memory, grid) and
:func:`k_slots` the k order that plan walks. Also K4b (below).

Layout: activations are NHWC-contiguous int8 tensors; a 3×3 kernel is
``(Co, 3, 3, Ci)`` int8 and a 2×2 transpose-conv kernel ``(Co, 2, 2, Ci)``
(channels innermost, as the activations). The TPU frame layout is not
carried over: SAME padding is the conv's own.

The plain convs sum in float64, where every s32 sum of int8 products is exact
(127·127·9·Cin < 2^53); float32 is not once Cin > 115. The float32 epilogue
then computes what JAX computes under ``jit``, where XLA fuses a multiply and
the add that consumes it into one fused multiply-add (FMA, a single rounding)
and rounds every other step once:

- ``scale_first=False``: ``fma(acc, s_in · w_scale, bias)`` (``quant._qconv``,
  the Pallas kernels);
- ``scale_first=True``: ``fma(acc · s_in, w_scale, bias)`` (the concat
  decoder, ``quant.py:237``);
- split with ``s_in2``: ``fma(fma(acc₁, s_in, acc₂ · s_in2), w_scale, bias)``
  (the split decoder, ``quant.py:242``: XLA fuses the first product).

``fma32`` is that exactly rounded float32 FMA on any device (through float64,
``tests/test_torch_epilogue.py`` holds each formula to JAX at searched ties).
Then ReLU where asked and ``clip(round(y · inv))`` to [0, 127] after a ReLU,
[−127, 127] without, with ``inv = float32(127) / float32(out_scale)`` as JAX
computes it inside ``jit``. Scalars are host floats, rounded to float32 once.

``qconv3x3_requant_dma`` (K4b, ``ops/qconv_pallas.py:qconv3x3_requant_dma``)
is K4a's product mode with one Cin chunk (Cin ≤ 128), on the TMA-fed int8
tensor-core kernel of K3a (``csrc/qconv3x3_requant_dma.cu``, its design note
there; its plan and weight packing are ``ops/nhwc_conv.py``'s).

``qconv3x3_requant``, ``qconv3x3_split_requant`` and ``qconv3x3_requant_dma``
launch their kernels for CUDA tensors and take their plain versions only for
CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from twinvoice_tpu_torch import _build

NAME = "qconv3x3"
K4A = "qconv3x3_requant"        # launch-count keys
K5 = "qconv3x3_split_requant"
K4B = "qconv3x3_requant_dma"    # also the name of K4b's library (launches also
                                # counted under "<key>:tma" or "<key>:copy")
K4B_MAX_CIN = 128
_PROD, _CHAIN, _SEPARATE = 0, 1, 2  # epilogue modes of the source
STEM, PAIR, WIDE = 0, 1, 2  # k layouts of csrc/qconv3x3.cu


def out_inv(out_scale) -> np.float32:
    """``127 / out_scale`` in float32, as ``quant._requant`` and the Pallas
    kernels compute it (``127.0 / s`` on a float32 scale)."""
    return np.float32(127.0) / np.float32(out_scale)


# -- plain int8 ops ------------------------------------------------------------


def conv3x3_i8(x, kernel):
    """int8 3×3 SAME conv: (N,H,W,Ci) int8, (Co,3,3,Ci) int8 → (N,H,W,Co)
    float64 holding the exact s32 sums (``quant._conv3x3_i8``)."""
    xf = x.permute(0, 3, 1, 2).to(torch.float64)
    kf = kernel.permute(0, 3, 1, 2).to(torch.float64)
    return F.conv2d(xf, kf, padding=1).permute(0, 2, 3, 1)


def conv_transpose2x2_i8(x, kernel):
    """int8 2×2 stride-2 transpose conv: (N,H,W,Ci) int8, (Co,2,2,Ci) int8 →
    (N,2H,2W,Co) float64 exact sums, ``y[2h+a, 2w+b, o] = Σ_c K[o,a,b,c]·x[h,w,c]``
    (``quant._conv_transpose2x2_i8``)."""
    n, h, w, _ = x.shape
    co = kernel.shape[0]
    y = torch.einsum("nhwc,oabc->nhawbo", x.to(torch.float64), kernel.to(torch.float64))
    return y.reshape(n, 2 * h, 2 * w, co)


def requant(y, out_scale, relu=True):
    """float32 → int8 at scale ``out_scale/127`` (``quant._requant``; the
    symmetric form with ``relu=False``). ReLU is applied here when asked."""
    if relu:
        y = torch.relu(y)
    inv = torch.tensor(out_inv(out_scale), device=y.device)
    return torch.clamp(torch.round(y * inv), 0.0 if relu else -127.0, 127.0).to(torch.int8)


def max_pool2_i8(x):
    """2×2 stride-2 max pool of (N,H,W,C) int8, floor mode. A reshape and
    ``amax`` is exact for int8 on any device."""
    n, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    x = x[:, : 2 * h2, : 2 * w2].reshape(n, h2, 2, w2, 2, c)
    return x.amax(dim=(2, 4))


def _scalar(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


def fma32(x, y, z):
    """The float32 fused multiply-add ``x·y + z`` rounded once, half to even,
    of float32 tensors (or scalars) broadcast together.

    The product of two float32 values is exact in float64; their float64 sum
    with ``z`` is rounded once more, so the sum is taken with its exact error
    (TwoSum) and rounded to odd: where the error is not zero and the sum's last
    bit is even, the sum steps one float64 ulp toward the error. A float64
    rounded to odd then rounds to float32 exactly as the exact value would
    (53 ≥ 24 + 2 bits)."""
    x, y, z = (torch.as_tensor(t).to(torch.float64) for t in (x, y, z))
    p = x * y
    s = p + z
    zz = s - p
    e = (p - (s - zz)) + (z - zz)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.full_like(s, np.inf), torch.full_like(s, -np.inf))
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def dequant(acc, w_scale, bias, s_in, *, scale_first=False):
    """Exact sums (float64) → float32 ``y`` by the formula ``scale_first``
    names (module doc), its last multiply fused with the bias add."""
    s = _scalar(s_in, acc.device)
    f = acc.to(torch.float32)
    if scale_first:
        return fma32(f * s, w_scale, bias)
    return fma32(f, s * w_scale, bias)


def dequant_split(acc, acc2, w_scale, bias, s_in, s_in2):
    """The split XLA form (``quant.py:242``): ``fma(fma(acc₁, s_in, acc₂·s_in2),
    w_scale, bias)``."""
    s, s2 = _scalar(s_in, acc.device), _scalar(s_in2, acc.device)
    t = fma32(acc.to(torch.float32), s, acc2.to(torch.float32) * s2)
    return fma32(t, w_scale, bias)


# -- K4a / K5 --------------------------------------------------------------------


def qconv3x3_requant_reference(x, kernel, w_scale, bias, s_in, out_scale, *,
                               relu=True, scale_first=False):
    """Plain version of :func:`qconv3x3_requant`."""
    y = dequant(conv3x3_i8(x, kernel), w_scale, bias, s_in, scale_first=scale_first)
    return requant(y, out_scale, relu).contiguous()


def qconv3x3_split_requant_reference(x, x2, kernel, kernel2, w_scale, bias, s_in,
                                     out_scale, *, s_in2=None, relu=True):
    """Plain version of :func:`qconv3x3_split_requant`."""
    acc, acc2 = conv3x3_i8(x, kernel), conv3x3_i8(x2, kernel2)
    if s_in2 is None:
        y = dequant(acc + acc2, w_scale, bias, s_in)
    else:
        y = dequant_split(acc, acc2, w_scale, bias, s_in, s_in2)
    return requant(y, out_scale, relu).contiguous()


# -- K4a / K5 launch plan -----------------------------------------------------------

TILE_W = 32                # output columns of a tile
SMEM_LIMIT = 232_448       # dynamic shared memory one block may use (H100)
SM_SMEM = 233_472          # shared memory of one SM, 1 KiB of it reserved a block
H100_SMS = 132


def tile_rows(nt: int) -> int:
    """Output rows of a tile: 8 warps of 4 m tiles (two rows) each up to 32
    output channels a block (nt ≤ 4), else of 2 (one row)."""
    return 16 if nt <= 4 else 8


def blocks_per_sm(nt: int, separate: bool = False) -> int:
    """Blocks an SM the kernel's registers allow (its ``__launch_bounds__``)."""
    return 3 if nt <= 2 and not separate else 2


class ConvPlan(NamedTuple):
    layout: int       # STEM (Cin ≤ 4), PAIR (Cin ≤ 16) or WIDE
    cc: int           # channels of one Cin chunk (4, 16, or 32/64/128)
    n_chunks: int     # chunks of one input
    items: int        # chunks a tile walks (both inputs for K5)
    nt: int           # n tiles of 8 output channels a block
    k_steps: int      # 32-byte k steps of one chunk
    stages: int       # slots of the shared-memory ring (items in flight + 1)
    resident: bool    # the block's weights stay in shared memory
    smem: int         # bytes of dynamic shared memory a block
    tiles: int        # output tiles of the batch, tile_rows(nt) × 32 pixels
    grid: tuple       # (blocks along the tiles, blocks along the output channels)

    @property
    def co_tile(self) -> int:
        return 8 * self.nt


def _pixel_bytes(c: int) -> int:
    """``c`` rounded up to 16 bytes, then to an odd number of 16-byte granules
    (``csrc/int8_conv_common.cuh:pixel_bytes``)."""
    g = -(-c // 16)
    return 16 * (g if g % 2 else g + 1)


def _k_steps(layout, cc, kw) -> int:
    """32-byte k steps of one chunk over the 3 × ``kw`` window's taps: 8 taps
    a step (STEM), 2 (PAIR), or ``cc``/32 a tap (WIDE)."""
    taps = 3 * kw
    return -(-taps // 8) if layout == STEM else -(-taps // 2) if layout == PAIR \
        else taps * cc // 32


def _smem(layout, cc, nt, items, stages, kw=3) -> int:
    """Bytes of ``stages`` slab slots, the weights (all ``items`` chunks when
    they fit in as many slots, else one a slot) and the output staging."""
    sa = 4 if layout == STEM else 16 if layout == PAIR else _pixel_bytes(cc)
    wb = _pixel_bytes(32 * _k_steps(layout, cc, kw))
    slab = (tile_rows(nt) + 2) * (TILE_W + 2) * sa
    return (stages * slab + min(items, stages) * 8 * nt * wb
            + tile_rows(nt) * TILE_W * _pixel_bytes(8 * nt))


def _fits(smem: int, nt: int, separate: bool) -> bool:
    """Shared memory lets as many blocks share an SM as the registers do."""
    return blocks_per_sm(nt, separate) * (smem + 1024) <= SM_SMEM


def conv_plan(n, h, w, cin, co, *, halves=1, separate=False, sms=H100_SMS,
              kw=3) -> ConvPlan:
    """The launch plan of ``csrc/qconv3x3.cu`` for an (n,h,w,cin) → co conv
    (``halves=2``: K5's two inputs; ``separate``: its two-sum form), or, with
    ``kw=2``, of K7b's 3×2 window over pairs (``csrc/qconv3x3_pair.cu``,
    ``ops/nhwc_conv.py:pair_plan``); ``w`` is the output's width.

    The k layout packs narrow inputs: eight taps a 32-byte k step for Cin ≤ 4,
    two for Cin ≤ 16, else 32 channels of one tap, in chunks of the widest
    ``cc`` of 128, 64, 32 (not past Cin) for which the most ring slots of 4, 3,
    2 let as many blocks share an SM as the registers do (32 channels and 2
    slots always do). The stem keeps 2 slots (its slabs come through registers two
    items ahead). A block takes up to 64 output channels (16 in the two-sum
    form, whose two register tiles must not spill) and tiles of
    ``tile_rows(nt)`` × 32 output pixels. The grid is persistent: as many
    blocks as fit on ``sms`` SMs, no more than tiles."""
    nt = 1 if co <= 8 else 2 if co <= 16 or separate else 4 if co <= 32 else 8
    if cin <= 4:
        layout, cc, stages = STEM, 4, 2
    else:
        layout = PAIR if cin <= 16 else WIDE
        ccs = (16,) if layout == PAIR else [c for c in (128, 64, 32)
                                            if c <= -(-cin // 32) * 32]
        cc, stages = next((c, st) for c in ccs for st in (4, 3, 2) if _fits(
            _smem(layout, c, nt, halves * -(-cin // c), st, kw), nt, separate))
    n_chunks = -(-cin // cc)
    items = halves * n_chunks
    smem = _smem(layout, cc, nt, items, stages, kw)
    n_co = -(-co // (8 * nt))
    tiles = n * -(-h // tile_rows(nt)) * -(-w // TILE_W)
    per_sm = max(1, min(blocks_per_sm(nt, separate), SM_SMEM // (smem + 1024)))
    blocks = max(1, min(tiles, -(-sms * per_sm // n_co)))
    return ConvPlan(layout, cc, n_chunks, items, nt, _k_steps(layout, cc, kw), stages,
                    items <= stages, smem, tiles, (blocks, n_co))


def k_slots(plan: ConvPlan, cin: int, kw: int = 3) -> np.ndarray:
    """The k order ``plan`` walks in one input: (n_chunks, k_steps, 32, 2) of
    (tap, input channel) per k byte, (−1, −1) where the slot is padding (its
    weight staged as zero). Taps are ``kw·dy + dx`` of the 3 × ``kw`` window."""
    taps = 3 * kw
    out = np.full((plan.n_chunks, plan.k_steps, 32, 2), -1, np.int64)
    j = np.arange(32)
    for chunk in range(plan.n_chunks):
        for s in range(plan.k_steps):
            if plan.layout == STEM:
                tap, ch = 8 * s + j // 4, j % 4
            elif plan.layout == PAIR:
                tap, ch = 2 * s + j // 16, j % 16
            else:
                per_tap = plan.cc // 32
                tap = np.full(32, s // per_tap)
                ch = chunk * plan.cc + 32 * (s % per_tap) + j
            ok = (tap < taps) & (ch < cin)
            out[chunk, s, ok, 0] = tap[ok]
            out[chunk, s, ok, 1] = ch[ok]
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _library():
    fn = _build.library(NAME).twv_qconv3x3_requant
    if fn.argtypes is None:
        ci, cf, vp = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, cf, cf, cf,
                       ci, ci, ci, ci, ci, ci, ci, ci, vp, vp]
        fn.restype = ctypes.c_int
    return fn


def check_operands(name, x, kernel, w_scale, bias, taps, scale_name="w_scale"):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    for t, what, dtype in ((x, "x", torch.int8), (kernel, "kernel", torch.int8),
                           (w_scale, scale_name, torch.float32),
                           (bias, "bias", torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{name}: {what} on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (N,H,W,C), got {tuple(x.shape)}")
    co = kernel.shape[0]
    if kernel.shape != (co, taps, taps, x.shape[3]):
        raise ValueError(f"{name}: kernel {tuple(kernel.shape)} for x "
                         f"{tuple(x.shape)}; expected (Co,{taps},{taps},Ci)")
    if w_scale.shape != (co,) or bias.shape != (co,):
        raise ValueError(f"{name}: {scale_name} {tuple(w_scale.shape)} and bias "
                         f"{tuple(bias.shape)} for {co} output channels")
    if min(x.shape) == 0 or co == 0:
        raise ValueError(f"{name}: empty shape {tuple(x.shape)} → {co}")
    return co


def _launch(name, x, x2, kernel, kernel2, w_scale, bias, s0, s1, out_scale, mode,
            relu, out=None):
    n, h, w, cin = x.shape
    co = kernel.shape[0]
    if out is None:
        out = torch.empty((n, h, w, co), dtype=torch.int8, device=x.device)
    plan = conv_plan(n, h, w, cin, co, halves=1 if x2 is None else 2,
                     separate=mode == _SEPARATE, sms=_sm_count(x.device.index or 0))
    fn = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), x2.data_ptr() if x2 is not None else None,
                 kernel.data_ptr(), kernel2.data_ptr() if kernel2 is not None else None,
                 w_scale.data_ptr(), bias.data_ptr(), n, h, w, cin, co,
                 float(s0), float(s1), float(out_inv(out_scale)), mode,
                 int(bool(relu)), plan.layout, plan.cc, plan.nt, plan.stages,
                 plan.smem, plan.grid[0], out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {err}")
    _build.launches[name] += 1
    return out


def qconv3x3_requant(x, kernel, w_scale, bias, s_in, out_scale, *, relu=True,
                     scale_first=False):
    """K4a: int8 3×3 SAME conv → float32 epilogue → int8.

    ``x``: (N,H,W,Ci) int8 NHWC-contiguous; ``kernel``: (Co,3,3,Ci) int8;
    ``w_scale``, ``bias``: (Co,) float32; ``s_in``, ``out_scale``: host
    floats. → (N,H,W,Co) int8. The epilogue is ``fma(acc, s_in·w_scale, bias)``,
    or ``fma(acc·s_in, w_scale, bias)`` with ``scale_first``; then ReLU where
    asked and the requant of ``quant._requant``.
    """
    if x.device.type == "cpu":
        return qconv3x3_requant_reference(x, kernel, w_scale, bias, s_in, out_scale,
                                          relu=relu, scale_first=scale_first)
    check_operands(K4A, x, kernel, w_scale, bias, 3)
    return _launch(K4A, x, None, kernel, None, w_scale, bias, s_in, 0.0, out_scale,
                   _CHAIN if scale_first else _PROD, relu)


def qconv3x3_split_requant(x, x2, kernel, kernel2, w_scale, bias, s_in, out_scale,
                           *, s_in2=None, relu=True):
    """K5: the decoder conv1 on two int8 inputs (upsample half ``x``, skip half
    ``x2``, equal shapes) with their two kernels, then K4a's epilogue.

    With ``s_in2=None`` both halves share one s32 sum and one dequant factor,
    ``fma(acc₁+acc₂, s_in·w_scale, bias)`` (the Pallas K5; valid because
    ``quantize_unet`` harmonises the two scales); with ``s_in2`` each half
    keeps its scale, ``fma(fma(acc₁, s_in, acc₂·s_in2), w_scale, bias)`` (the
    split XLA form, ``quant.py:242``).
    """
    if x.device.type == "cpu":
        return qconv3x3_split_requant_reference(
            x, x2, kernel, kernel2, w_scale, bias, s_in, out_scale, s_in2=s_in2,
            relu=relu)
    check_operands(K5, x, kernel, w_scale, bias, 3)
    check_operands(K5, x2, kernel2, w_scale, bias, 3)
    if x2.shape != x.shape or kernel2.shape != kernel.shape:
        raise ValueError(f"{K5}: halves {tuple(x.shape)}/{tuple(x2.shape)}, kernels "
                         f"{tuple(kernel.shape)}/{tuple(kernel2.shape)} differ")
    if s_in2 is None:
        return _launch(K5, x, x2, kernel, kernel2, w_scale, bias, s_in, 0.0,
                       out_scale, _PROD, relu)
    return _launch(K5, x, x2, kernel, kernel2, w_scale, bias, s_in, s_in2, out_scale,
                   _SEPARATE, relu)


# -- K4b ---------------------------------------------------------------------------


def qconv3x3_requant_dma_reference(x, kernel, a, bias, out_scale, *, relu=True):
    """Plain version of :func:`qconv3x3_requant_dma`."""
    y = fma32(conv3x3_i8(x, kernel).to(torch.float32), a, bias)
    return requant(y, out_scale, relu).contiguous()


def qconv3x3_requant_dma(x, kernel, a, bias, out_scale, *, relu=True, mxu_bf16=False):
    """K4b: K4a's product mode with the dequant factor given, one Cin chunk.

    ``x``: (N,H,W,Ci) int8 NHWC-contiguous with Ci ≤ 128 (``ValueError``
    otherwise, as JAX asserts one chunk); ``kernel``: (Co,3,3,Ci) int8;
    ``a``: (Co,) float32 ``s_in·w_scale``, as JAX's kernel takes it; ``bias``:
    (Co,) float32; ``out_scale``: a host float. → (N,H,W,Co) int8,
    ``clip(round(relu(fma(acc, a, bias))·127/out_scale))`` with the SAME conv's
    s32 sum ``acc``, equal to K4a's.

    ``mxu_bf16`` is accepted and changes nothing: JAX's bf16 mode sums in
    float32, exact only while every partial sum stays under 2^24
    (127·127·9·Ci < 2^24 holds for Ci ≤ 115; at Ci 116–128 it is exact only
    for inputs that are not extreme); the kernel's sum is s32, exact at any Ci.
    """
    del mxu_bf16
    if x.dim() == 4 and x.shape[3] > K4B_MAX_CIN:
        raise ValueError(f"{K4B}: Cin {x.shape[3]} > {K4B_MAX_CIN} (one Cin chunk)")
    if x.device.type == "cpu":
        return qconv3x3_requant_dma_reference(x, kernel, a, bias, out_scale, relu=relu)
    from twinvoice_tpu_torch.ops import nhwc_conv  # which imports this module

    co = check_operands(K4B, x, kernel, a, bias, 3, scale_name="a")
    out = torch.empty((*x.shape[:3], co), dtype=torch.int8, device=x.device)
    return nhwc_conv._launch_dma(K4B, x, kernel, a, bias, out_scale, relu, out)
