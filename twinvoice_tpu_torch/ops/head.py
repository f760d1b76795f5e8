"""K2: the fused int8 serving head (1×1 logit conv + row/col max), as a CUDA
kernel, and the box read from its maxima.

Replaces ``twinvoice_tpu/ops/pallas_head.py:head_rowcol_max``; the kernel
(``csrc/head_rowcol_max.cu``) and its design note are there.
``bbox_from_rowcol_max`` is ``pallas_head.py:bbox_from_rowcol_max``, plain
torch. The head of the JAX Pallas trunk
(``qconv_pallas.py:head_rowcol_max_frame``) is an XLA einsum there, so the
port's Pallas-form trunk uses ``head_rowcol_max_reference`` for it. The
packed head of the JAX W-phase trunk (``infer/wpack.py``) is a float32 XLA
conv; the port computes it with K2 and float32 weights
(``compute_dtype=torch.float32``).

``head_rowcol_max`` launches the kernel for a CUDA tensor and takes the plain
version only for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from twinvoice_tpu_torch import _build

NAME = "head_rowcol_max"
BLOCKS_PER_SM = 4  # bands per image are chosen to give this many blocks
MAX_BAND_ROWS = 256  # bounds the per-warp row maxima kept in shared memory


def head_weight(w, act_scale, compute_dtype=torch.bfloat16):
    """(C,3) float32 out-conv weight → ``w · act_scale`` rounded to
    ``compute_dtype`` (bf16 as ``pallas_head.py:101``, or float32), as
    float32; ``act_scale`` is a host float rounded to float32."""
    s = torch.tensor(act_scale, dtype=torch.float32, device=w.device)
    return (w.to(torch.float32) * s).to(compute_dtype).to(torch.float32)


def head_rowcol_max_reference(h_nhwc_s8, w, act_scale, compute_dtype=torch.bfloat16):
    """Plain version of :func:`head_rowcol_max`: the bias-free logits in
    float32 (int8 × bf16 products are exact there; float32 weights round each
    product once), then their maxima."""
    logits = h_nhwc_s8.to(torch.float32) @ head_weight(w, act_scale, compute_dtype)
    return logits.amax(dim=2), logits.amax(dim=1)


def _library():
    fn = _build.library(NAME).twv_head_rowcol_max
    if fn.argtypes is None:
        ci, cf, vp = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fn.argtypes = [vp, vp, cf, ci, ci, ci, ci, ci, ci, ci, vp, vp, vp, vp]
        fn.restype = ctypes.c_int
    return fn


def _bands(b, h, device):
    """→ (bands, rows): ``b * bands`` blocks fill the card, no band is empty
    and none has more than ``MAX_BAND_ROWS`` rows."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    bands = max(1, min(h, -(-BLOCKS_PER_SM * sms // b)), -(-h // MAX_BAND_ROWS))
    rows = -(-h // bands)
    return -(-h // rows), rows


def head_rowcol_max(h_nhwc_s8, w, act_scale, compute_dtype=torch.bfloat16):
    """K2: (B,H,W,C) int8 NHWC-contiguous final activations, (C,3) float32
    out-conv weight, host float ``act_scale`` → (row_max (B,H,3), col_max
    (B,W,3)) float32 maxima of the *bias-free* logits ``x · wf``, ``wf =
    w·act_scale`` rounded to ``compute_dtype``: bf16 as the Pallas head, or
    float32 for the W-phase heads, whose JAX form is a float32 XLA conv.
    Callers fold the out-conv bias into their thresholds."""
    x = h_nhwc_s8
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{NAME}: compute_dtype must be bfloat16 or float32, "
                         f"got {compute_dtype}")
    if x.device.type == "cpu":
        return head_rowcol_max_reference(x, w, act_scale, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for {x.device}")
    if x.dtype != torch.int8 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{NAME}: x must be (B,H,W,C) int8 contiguous, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, h, wd, c = x.shape
    if min(x.shape) == 0 or b > 65535:
        raise ValueError(f"{NAME}: shape {tuple(x.shape)} not taken")
    if (w.device != x.device or w.dtype != torch.float32 or w.shape != (c, 3)
            or not w.is_contiguous()):
        raise ValueError(f"{NAME}: w must be ({c},3) float32 contiguous on "
                         f"{x.device}, got {tuple(w.shape)} {w.dtype} {w.device}")
    bands, rows = _bands(b, h, x.device)
    partial = torch.empty((b, bands, wd, 3), dtype=torch.float32, device=x.device)
    row_max = torch.empty((b, h, 3), dtype=torch.float32, device=x.device)
    col_max = torch.empty((b, wd, 3), dtype=torch.float32, device=x.device)
    fn = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), float(act_scale),
                 int(compute_dtype == torch.bfloat16), b, h, wd, c,
                 bands, rows, partial.data_ptr(), row_max.data_ptr(),
                 col_max.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{NAME}: kernel launch failed, cudaError {err}")
    _build.launches[NAME] += 1
    return row_max, col_max


def bbox_from_rowcol_max(row_max, col_max, logit_thresholds):
    """Batched box from row/col logit maxima (``pallas_head.py:142``): a row
    (column) is active iff its max is above the class threshold. ``row_max``
    (B,H,C), ``col_max`` (B,W,C) float32; ``logit_thresholds`` (C,) with the
    out-conv bias folded in (t − b). → (boxes (B,C,4) int32 [x1,y1,x2,y2]
    inclusive, valid (B,C) bool), the sentinel (W,H,−1,−1) for an empty class."""
    h, w = row_max.shape[1], col_max.shape[1]
    thr = torch.as_tensor(logit_thresholds, dtype=torch.float32).to(row_max.device)
    rows = row_max > thr
    cols = col_max > thr
    yi = torch.arange(h, dtype=torch.int32, device=rows.device)[:, None]
    xi = torch.arange(w, dtype=torch.int32, device=cols.device)[:, None]
    y1 = torch.where(rows, yi, h).amin(dim=1)
    y2 = torch.where(rows, yi, -1).amax(dim=1)
    x1 = torch.where(cols, xi, w).amin(dim=1)
    x2 = torch.where(cols, xi, -1).amax(dim=1)
    return torch.stack([x1, y1, x2, y2], dim=-1), rows.any(dim=1)
