"""K6: the int8 2×2 stride-2 transpose conv with its requant, as a CUDA kernel.

Replaces ``twinvoice_tpu/ops/qconv_pallas.py:qupsample2x2_requant``; the
kernel (``csrc/qupsample2x2.cu``, a GEMM on the int8 tensor cores) and its
design note are there. :func:`qupsample_plan` computes the launch plan it is
given, :func:`qupsample_k_slots` and :func:`qupsample_columns` the k order
and the column order that plan walks. Layouts and rounding are those of
:mod:`twinvoice_tpu_torch.ops.qconv`.

``qupsample2x2_requant`` launches the kernel for a CUDA tensor and takes the
plain version only for a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from twinvoice_tpu_torch import _build
from twinvoice_tpu_torch.ops.qconv import (
    H100_SMS,
    SM_SMEM,
    SMEM_LIMIT,
    _pixel_bytes,
    _sm_count,
    check_operands,
    conv_transpose2x2_i8,
    dequant,
    out_inv,
    requant,
)

NAME = "qupsample2x2"
K6 = "qupsample2x2_requant"  # launch-count key
BLOCKS_PER_SM = 2  # the kernel's __launch_bounds__


class UpsamplePlan(NamedTuple):
    co_tile: int    # output channels a block (8, 16 or 32): 4·co_tile GEMM columns
    tile_m: int     # input pixels of a tile (256, or 128 at 32 channels a block)
    kc: int         # channels of one Cin chunk (32, 64 or 128)
    k_chunks: int   # chunks of Cin
    stages: int     # slots of the shared-memory ring (2 to 4)
    resident: bool  # the block's weights stay in shared memory
    smem: int       # bytes of dynamic shared memory a block
    tiles: int      # pixel tiles of the batch
    grid: tuple     # (blocks along the tiles, blocks along the output channels)

    @property
    def k_steps(self) -> int:
        return self.kc // 32


def _tile_m(co_tile) -> int:
    """Input pixels of a tile (``csrc/qupsample2x2.cu:tile_pixels``)."""
    return 128 if co_tile == 32 else 256


def _smem(co_tile, kc, k_chunks, stages) -> int:
    """Bytes of ``stages`` pixel slots, the weights (every chunk when they
    fit in as many slots, else one a slot), the output staging and each
    column's two epilogue factors (``csrc/qupsample2x2.cu``)."""
    tm = _tile_m(co_tile)
    row = _pixel_bytes(kc)
    return (stages * tm * row + min(k_chunks, stages) * 4 * co_tile * row
            + tm * _pixel_bytes(4 * co_tile) + 2 * 4 * 4 * co_tile)


def qupsample_plan(n, h, w, cin, co, *, sms=H100_SMS) -> UpsamplePlan:
    """The launch plan of ``csrc/qupsample2x2.cu`` for an (n,h,w,cin) input
    and ``co`` output channels.

    A block takes 8, 16 or 32 output channels (the fewest that hold Co, up to
    32) and tiles of 256 input pixels (128 at 32 channels); Cin goes in chunks
    of the widest ``kc`` of 128, 64, 32 (not past Cin rounded up to 32) for
    which the most ring slots of 4, 3, 2 let two blocks share an SM. The grid
    is persistent: as many blocks as fit on ``sms`` SMs, no more than
    tiles."""
    co_tile = 8 if co <= 8 else 16 if co <= 16 else 32
    kcs = [c for c in (128, 64, 32) if c <= -(-cin // 32) * 32]
    kc, stages = next((c, st) for c in kcs for st in (4, 3, 2)
                      if BLOCKS_PER_SM * (_smem(co_tile, c, -(-cin // c), st) + 1024)
                      <= SM_SMEM)
    k_chunks = -(-cin // kc)
    smem = _smem(co_tile, kc, k_chunks, stages)
    assert smem <= SMEM_LIMIT
    tile_m = _tile_m(co_tile)
    tiles = -(-(n * h * w) // tile_m)
    n_co = -(-co // co_tile)
    blocks = max(1, min(tiles, -(-sms * BLOCKS_PER_SM // n_co)))
    return UpsamplePlan(co_tile, tile_m, kc, k_chunks, stages, k_chunks <= stages, smem,
                        tiles, (blocks, n_co))


def qupsample_k_slots(plan: UpsamplePlan, cin: int) -> np.ndarray:
    """The k order ``plan`` walks: (k_chunks, k_steps, 32) input channel per
    k byte, −1 where the slot is padding (its weight staged as zero)."""
    ch = np.arange(plan.k_chunks * plan.kc).reshape(plan.k_chunks, plan.k_steps, 32)
    return np.where(ch < cin, ch, -1)


def qupsample_columns(plan: UpsamplePlan, co: int) -> np.ndarray:
    """The GEMM columns of each block: (n_co, 4·co_tile, 2) of (tap ``2·dy +
    dx``, output channel), tap-major within a block, (−1, −1) past Co."""
    n = np.arange(4 * plan.co_tile)
    out = np.full((plan.grid[1], 4 * plan.co_tile, 2), -1, np.int64)
    for b in range(plan.grid[1]):
        ch = b * plan.co_tile + n % plan.co_tile
        ok = ch < co
        out[b, ok, 0] = (n // plan.co_tile)[ok]
        out[b, ok, 1] = ch[ok]
    return out


def qupsample2x2_requant_reference(x, kernel, w_scale, bias, s_in, out_scale):
    """Plain version of :func:`qupsample2x2_requant`."""
    y = dequant(conv_transpose2x2_i8(x, kernel), w_scale, bias, s_in)
    return requant(y, out_scale, relu=False).contiguous()


def _library():
    fn = _build.library(NAME).twv_qupsample2x2_requant
    if fn.argtypes is None:
        ci, cf, vp = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, cf, cf, ci, ci, ci, ci, ci,
                       vp, vp]
        fn.restype = ctypes.c_int
    return fn


def qupsample2x2_requant(x, kernel, w_scale, bias, s_in, out_scale):
    """K6: (N,H,W,Ci) int8 NHWC-contiguous, (Co,2,2,Ci) int8 kernel, (Co,)
    float32 ``w_scale`` and ``bias``, host floats ``s_in`` and ``out_scale``
    → (N,2H,2W,Co) int8 ``clip(round(fma(acc, s_in·w_scale, bias)·127/out_scale),
    −127, 127)``, with ``acc[2h+a, 2w+b, o] = Σ_c K[o,a,b,c]·x[h,w,c]``. No ReLU:
    the reference graph applies none after the upsample."""
    if x.device.type == "cpu":
        return qupsample2x2_requant_reference(x, kernel, w_scale, bias, s_in, out_scale)
    check_operands(K6, x, kernel, w_scale, bias, 2)
    return _launch(x, kernel, w_scale, bias, s_in, out_scale)


def _launch(x, kernel, w_scale, bias, s_in, out_scale, out=None):
    """Launch K6 on checked operands into ``out`` (a new tensor by default)."""
    n, h, w, cin = x.shape
    co = kernel.shape[0]
    if out is None:
        out = torch.empty((n, 2 * h, 2 * w, co), dtype=torch.int8, device=x.device)
    plan = qupsample_plan(n, h, w, cin, co, sms=_sm_count(x.device.index or 0))
    fn = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), kernel.data_ptr(), w_scale.data_ptr(), bias.data_ptr(),
                 n, h, w, cin, co, float(s_in), float(out_inv(out_scale)), plan.co_tile,
                 plan.kc, plan.stages, plan.smem, plan.grid[0], out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{K6}: kernel launch failed, cudaError {err}")
    _build.launches[K6] += 1
    return out
