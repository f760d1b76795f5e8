"""K1: the fused threshold → per-class box reduction, as a CUDA kernel.

Replaces ``twinvoice_tpu/ops/pallas/postprocess.py:bbox_postprocess_pallas``.
The kernel (``csrc/bbox_postprocess.cu``) is bound by reading the logits once
from device memory; its design note is in the source.

``bbox_postprocess`` launches the kernel for a CUDA tensor and takes the
plain PyTorch version (``bbox_postprocess_reference``) only for a CPU
tensor. There is no fallback: a CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import torch

from twinvoice_tpu_torch import _build

NAME = "bbox_postprocess"
MAX_CLASSES = 4  # kMaxClasses in the source
BLOCKS_PER_SM = 4  # bands per image are chosen to give this many blocks
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def bbox_postprocess_reference(logits, logit_thresholds):
    """The plain PyTorch version: (B,H,W,C) logits, (C,) logit-space
    thresholds → ((B,C,4) int32 grid boxes, (B,C) bool valid)."""
    # imported here: the ``infer`` package imports this module
    from twinvoice_tpu_torch.infer.postprocess import bbox_from_logits_fast

    return bbox_from_logits_fast(logits, logit_thresholds)


def _library():
    lib = _build.library(NAME)
    fn = lib.twv_bbox_postprocess
    if fn.argtypes is None:
        ll = ctypes.c_longlong
        ci, vp = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [vp, ci, ci, ci, ci, ci, ll, ll, ll, ll, ci, ci,
                       ctypes.POINTER(ctypes.c_float), vp, vp, vp, vp, vp]
        fn.restype = ctypes.c_int
    return fn


def _bands(b, h, device):
    """Bands of rows per image so that ``b * slices`` blocks fill the card:
    → (slices, rows) with ``slices * rows >= h`` and no empty band."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    slices = max(1, min(h, -(-BLOCKS_PER_SM * sms // b)))
    rows = max(1, -(-h // slices))
    return max(1, -(-h // rows)), rows


def bbox_postprocess(logits, logit_thresholds):
    """(B,H,W,C) float32/bfloat16 logits, any strides (an NCHW tensor viewed
    as NHWC is read in place), and (C,) logit-space thresholds held on the
    host → ((B,C,4) int32 grid boxes [x1,y1,x2,y2] inclusive, (B,C) bool
    valid). Equal to ``bbox_from_logits_fast`` on the same inputs."""
    if logits.device.type == "cpu":
        return bbox_postprocess_reference(logits, logit_thresholds)
    if logits.device.type != "cuda":
        raise ValueError(f"bbox_postprocess: no kernel for {logits.device}")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"bbox_postprocess: logits must be float32 or bfloat16, "
                        f"got {logits.dtype}")
    if logits.dim() != 4:
        raise ValueError(f"bbox_postprocess: logits must be (B,H,W,C), got "
                         f"{tuple(logits.shape)}")
    b, h, w, c = logits.shape
    thr = torch.as_tensor(logit_thresholds, dtype=torch.float32).cpu().contiguous()
    if thr.shape != (c,):
        raise ValueError(f"bbox_postprocess: {tuple(thr.shape)} thresholds for "
                         f"{c} classes")
    if not 1 <= c <= MAX_CLASSES:
        raise ValueError(f"bbox_postprocess: 1..{MAX_CLASSES} classes, got {c}")
    if h * w >= 2 ** 31 or b > 65535:
        raise ValueError(f"bbox_postprocess: shape {tuple(logits.shape)} too large")
    strides = logits.stride()
    if min(strides) < 0:
        raise ValueError(f"bbox_postprocess: negative strides {strides}")
    boxes = torch.empty((b, c, 4), dtype=torch.int32, device=logits.device)
    valid = torch.empty((b, c), dtype=torch.bool, device=logits.device)
    if b == 0:
        return boxes, valid
    slices, rows = _bands(b, h, logits.device)
    partial = torch.empty((b, slices, c, 4), dtype=torch.int32, device=logits.device)
    done = torch.zeros((b,), dtype=torch.int32, device=logits.device)
    fn = _library()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = fn(logits.data_ptr(), _DTYPES[logits.dtype], b, h, w, c, *strides,
                 slices, rows,
                 thr.numpy().ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                 partial.data_ptr(), done.data_ptr(), boxes.data_ptr(),
                 valid.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bbox_postprocess: kernel launch failed, cudaError {err}")
    _build.launches[NAME] += 1
    return boxes, valid
