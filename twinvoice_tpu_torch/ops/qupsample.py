"""K6: the int8 2×2 stride-2 transpose conv with its requant, as a CUDA kernel.

Replaces ``twinvoice_tpu/ops/qconv_pallas.py:qupsample2x2_requant``; the
kernel (``csrc/qupsample2x2.cu``) and its design note are there. Layouts and
rounding are those of :mod:`twinvoice_tpu_torch.ops.qconv`.

``qupsample2x2_requant`` launches the kernel for a CUDA tensor and takes the
plain version only for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from twinvoice_tpu_torch import _build
from twinvoice_tpu_torch.ops.qconv import (
    check_operands,
    conv_transpose2x2_i8,
    dequant,
    out_inv,
    requant,
)

NAME = "qupsample2x2"
K6 = "qupsample2x2_requant"  # launch-count key


def qupsample2x2_requant_reference(x, kernel, w_scale, bias, s_in, out_scale):
    """Plain version of :func:`qupsample2x2_requant`."""
    y = dequant(conv_transpose2x2_i8(x, kernel), w_scale, bias, s_in)
    return requant(y, out_scale, relu=False).contiguous()


def _library():
    fn = _build.library(NAME).twv_qupsample2x2_requant
    if fn.argtypes is None:
        ci, cf, vp = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, cf, cf, vp, vp]
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
    co = check_operands(K6, x, kernel, w_scale, bias, 2)
    n, h, w, cin = x.shape
    out = torch.empty((n, 2 * h, 2 * w, co), dtype=torch.int8, device=x.device)
    fn = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), kernel.data_ptr(), w_scale.data_ptr(), bias.data_ptr(),
                 n, h, w, cin, co, float(s_in), float(out_inv(out_scale)),
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{K6}: kernel launch failed, cudaError {err}")
    _build.launches[K6] += 1
    return out
