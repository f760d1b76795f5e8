"""Box post-processing: per-field threshold → grid box → scale and pad.

Ports of ``twinvoice_tpu.infer.postprocess``. The JAX functions take one
image and are vmapped; these take any leading batch dims, ``(..., H, W, C)``
in the JAX package's NHWC order, and return the same values: int32 boxes
``[x1,y1,x2,y2]`` (inclusive on the grid), the sentinel ``(W, H, -1, -1)``
for an empty class, and all box arithmetic in float32 in the same order.
"""

from __future__ import annotations

import torch


def _box_from_rows_cols(rows, cols, h, w):
    """rows (..., H, C), cols (..., W, C) bool → boxes (..., C, 4) int32."""
    yi = torch.arange(h, dtype=torch.int32, device=rows.device)[:, None]
    xi = torch.arange(w, dtype=torch.int32, device=cols.device)[:, None]
    y1 = torch.where(rows, yi, h).amin(dim=-2)
    y2 = torch.where(rows, yi, -1).amax(dim=-2)
    x1 = torch.where(cols, xi, w).amin(dim=-2)
    x2 = torch.where(cols, xi, -1).amax(dim=-2)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def bbox_from_probs(prob, thresholds):
    """Per-class mask box on the model grid. ``prob``: (..., H, W, C);
    ``thresholds``: (C,). → (boxes (..., C, 4) int32, valid (..., C) bool)."""
    h, w = prob.shape[-3], prob.shape[-2]
    thr = torch.as_tensor(thresholds, dtype=prob.dtype, device=prob.device)
    mask = prob > thr
    rows = mask.any(dim=-2)
    cols = mask.any(dim=-3)
    return _box_from_rows_cols(rows, cols, h, w), rows.any(dim=-2)


def bbox_from_logits_fast(logits, logit_thresholds):
    """Box via max-reductions on raw logits: ``max(x) > logit(t) ⟺
    any(sigmoid(x) > t)``, so it equals ``bbox_from_probs(sigmoid(x), t)``.

    ``logits``: (..., H, W, C) in any float dtype (reduced in that dtype, then
    compared in float32); ``logit_thresholds``: (C,) float32.
    """
    h, w = logits.shape[-3], logits.shape[-2]
    thr = torch.as_tensor(logit_thresholds, dtype=torch.float32,
                          device=logits.device)
    rows = logits.amax(dim=-2).to(torch.float32) > thr  # (..., H, C)
    cols = logits.amax(dim=-3).to(torch.float32) > thr  # (..., W, C)
    return _box_from_rows_cols(rows, cols, h, w), rows.any(dim=-2)


def probability_to_logit_thresholds(thresholds):
    """→ (C,) float32 CPU tensor ``log(t) − log1p(−t)``.

    Computed on the CPU in float32, where it equals the JAX package's value
    bit for bit; callers move it to the device they need.
    """
    t = torch.as_tensor(thresholds, dtype=torch.float32)
    return torch.log(t) - torch.log1p(-t)


def scale_and_pad_boxes(boxes, valid, orig_size, grid_size, pad_frac):
    """Map grid boxes to original-image pixel boxes with reference semantics.

    ``boxes``: (..., C, 4) int32; ``valid``: (..., C); ``orig_size``: (..., 2)
    int32 = (ow, oh). → ((..., C, 4) int32 [x1,y1,x2,y2], ok (..., C) bool).
    """
    boxes = boxes.to(torch.float32)
    size = orig_size.to(torch.float32)
    ow = size[..., 0:1]  # broadcasts over C
    oh = size[..., 1:2]
    sx = ow / grid_size
    sy = oh / grid_size
    x1 = torch.floor(boxes[..., 0] * sx)
    y1 = torch.floor(boxes[..., 1] * sy)
    x2 = torch.floor(boxes[..., 2] * sx)
    y2 = torch.floor(boxes[..., 3] * sy)
    frac = torch.tensor(pad_frac, dtype=torch.float32, device=boxes.device)
    pad_x = torch.floor((x2 - x1) * frac)
    pad_y = torch.floor((y2 - y1) * frac)
    x1 = torch.clamp_min(x1 - pad_x, 0.0)
    y1 = torch.clamp_min(y1 - pad_y, 0.0)
    x2 = torch.minimum(ow, x2 + pad_x)
    y2 = torch.minimum(oh, y2 + pad_y)
    ok = valid & (x2 > x1) & (y2 > y1)
    out = torch.stack([x1, y1, x2, y2], dim=-1).to(torch.int32)
    return out, ok
