"""The segmenter serving path (``twinvoice_tpu.infer.pipeline.Segmenter``).

uint8 batch → (device resize) → normalise → BN-folded U-Net → per-field box
(K1, ``ops.bbox_postprocess``) → scale and pad → boxes back to the host →
crops. The model is folded and moved to its device once. Everything up to the
boxes stays on the device; only the crop slice touches the host.

With ``int8_calib`` the forward is the int8 one (``infer.quant``), on the
routes of the JAX ``Segmenter`` (``pipeline.py:124-248``):

- ``int8_head="xla"`` (default) and the masks path of every int8 route: the
  concat-form int8 trunk (K4a, K6), float32 logits, K1;
- ``int8_head="xla-bf16"``, box-only: the same with bf16 logits;
- ``int8_head="pallas"``, box-only: the same trunk, then K2's row/col maxima;
- ``int8_pallas=True``, box-only: the Pallas-form trunk (K4a, K5, K6) and
  its plain head;
- ``int8_wpack=True|"full"|"enc"`` (``infer.wpack``), box-only: the W-phase
  trunk, whose bits are the concat trunk's (K4a, K6), then K2 with float32
  weights; with masks, its float32 logits and K1;
- ``int8_wpack="nhwc"``, box-only: the W-phase trunk with its three
  full-resolution convs in K7b, then K2 with float32 weights; the masks path
  and the device resize fall back to ``"full"`` (a ``UserWarning`` at
  construction says so);
- device resize (``pre_resized=False``): resize, round to uint8, then the
  ``"xla"`` route (the W-phase logits with ``int8_wpack``); it always
  returns the masks, as JAX's does.

On the box-only path ``int8_head="pallas"`` and ``int8_pallas`` take
precedence over ``int8_wpack``, and ``"xla-bf16"`` does not change a W-phase
route.

On the head routes the out-conv bias is folded into the thresholds
(``thr_eff = logit_thr − out_bias`` in float32).

Public layout is the JAX package's: NHWC uint8 images in; masks
``(B,S,S,3)`` bool, boxes ``(B,3,4)`` int32 ``[x1,y1,x2,y2]`` and ok
``(B,3)`` bool out, as torch tensors on the segmenter's device.

Pillow and OpenCV are imported only inside the PIL entry points, as the JAX
package does. The array entry points (``segment_array_batch``,
``segment_array``) take uint8 RGB pages at their own sizes and do the host
resize in numpy, exact to the JAX package's OpenCV and Pillow calls
(``ops.host_image``); :func:`crop_fields` is the crop rule on numpy arrays.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from twinvoice_tpu_torch import FIELDS, resolve_device
from twinvoice_tpu_torch.config import InferConfig, UNetConfig
from twinvoice_tpu_torch.infer.postprocess import (
    probability_to_logit_thresholds,
    scale_and_pad_boxes,
)
from twinvoice_tpu_torch.infer.quant import (
    prepack_head,
    prepack_pallas,
    quantize_unet,
    unet_apply_quantized,
    unet_apply_quantized_pallas_rowcol_max,
    unet_apply_quantized_rowcol_max,
)
from twinvoice_tpu_torch.infer.wpack import (
    prepack_nhwc,
    unet_apply_quantized_nhwc_rowcol_max,
    unet_apply_quantized_wpack,
    unet_apply_quantized_wpack_rowcol_max,
)
from twinvoice_tpu_torch.models.unet import fold_unet, unet_apply_folded
from twinvoice_tpu_torch.ops.bbox_postprocess import bbox_postprocess
from twinvoice_tpu_torch.ops.head import bbox_from_rowcol_max
from twinvoice_tpu_torch.ops.host_image import (
    resize_area_u8,
    resize_pil_bicubic,
    rgb_to_gray,
)
from twinvoice_tpu_torch.ops.image import normalize_uint8, resize_bilinear

INT8_HEADS = ("xla", "xla-bf16", "pallas")


def crop_fields(page, boxes, ok, black_crop_mean):
    """The crop rule of the JAX ``Segmenter`` on a numpy page.

    ``page``: (H, W) or (H, W, C) uint8 at original resolution; ``boxes``:
    (3, 4) int [x1,y1,x2,y2] and ``ok``: (3,) from ``segment_batch``. →
    {field: the (y1:y2, x1:x2) view of ``page``, or None when the field was
    not found, the crop is empty, or its mean is below ``black_crop_mean``
    (an all-black crop)}.
    """
    crops = {}
    for i, f in enumerate(FIELDS):
        if not ok[i]:
            crops[f] = None
            continue
        x1, y1, x2, y2 = (int(v) for v in boxes[i])
        carr = page[y1:y2, x1:x2]
        if carr.size == 0 or carr.mean() < black_crop_mean:
            crops[f] = None
            continue
        crops[f] = carr
    return crops


def _pil_crops(pil_img, boxes, ok, black_crop_mean):
    """crop_fields on a PIL image; kept crops come back as PIL images."""
    arrs = crop_fields(np.asarray(pil_img), boxes, ok, black_crop_mean)
    return {
        f: None if arrs[f] is None
        else pil_img.crop(tuple(int(v) for v in boxes[i]))
        for i, f in enumerate(FIELDS)
    }


class Segmenter:
    """Field segmenter holding a BN-folded U-Net on its device."""

    def __init__(self, params, state, model_cfg: UNetConfig = UNetConfig(),
                 cfg: InferConfig = InferConfig(), dtype=torch.float32,
                 device=None, int8_calib=None, int8_pallas=None,
                 int8_head="xla", int8_wpack=False, int8_scales=None):
        """``params``/``state``: torch-layout trees (``weights.load_npz`` or
        ``weights.from_jax_params``). ``device=None`` means ``"cuda"`` and
        raises without a card; pass ``device="cpu"`` to run on the CPU, where
        every kernel runs as its plain PyTorch version.

        ``int8_calib``: an iterable of uint8 (B,H,W,3) batches switches the
        forward to int8, weights quantized per channel and activation scales
        calibrated on these batches; ``int8_scales`` (a scales tree of
        ``infer.quant.calibrate``) gives the scales instead. ``int8_pallas``
        and ``int8_head`` pick the box-only route, ``int8_wpack`` (True,
        ``"full"``, ``"enc"`` or ``"nhwc"``; ignored without int8) the
        W-phase trunk (module doc).
        """
        if int8_wpack == "nhwc":
            warnings.warn(
                "int8_wpack='nhwc' applies only to the box-only "
                "(return_masks=False) path; mask paths fall back to the "
                "W-phase trunk (mode='full')", stacklevel=2)
        if int8_head not in INT8_HEADS:
            raise ValueError(f"int8_head must be one of {INT8_HEADS}, got {int8_head!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.dtype = dtype
        self.folded = fold_unet(params, state, cfg=model_cfg, dtype=dtype,
                                device=self.device)
        self._thr = torch.tensor(cfg.thresholds, dtype=torch.float32,
                                 device=self.device)
        # host float32 values; the kernel takes them as launch arguments
        self._logit_thr = probability_to_logit_thresholds(cfg.thresholds)
        self.int8_head = int8_head
        self.qparams = None
        self.pallas_params = None
        self.head_params = None  # the logits head's tensors, made once
        self.wpack_mode = None  # "full" or "enc" when the W-phase trunk serves
        self.nhwc_params = None  # the "nhwc" trunk's K7b operands when it serves
        self._copy_stream = None  # the host-to-device copies' stream, on a card
        if int8_calib is not None or int8_scales is not None:
            folded32 = fold_unet(params, state, cfg=model_cfg, dtype=torch.float32,
                                 device=self.device)
            self.qparams = quantize_unet(folded32, int8_calib, scales=int8_scales)
            self.head_params = prepack_head(self.qparams)
            if int8_pallas:
                self.pallas_params = prepack_pallas(self.qparams)
            if int8_wpack:
                self.wpack_mode = "enc" if int8_wpack == "enc" else "full"
                if int8_wpack == "nhwc":
                    self.nhwc_params = prepack_nhwc(self.qparams)
            out_bias = self.qparams["out"]["bias"].cpu()
            self._thr_eff = (self._logit_thr - out_bias).to(self.device)

    # -- device graph ------------------------------------------------------

    def _forward(self, x, orig_sizes, return_masks):
        """x: (B,3,S,S) in ``self.dtype``; orig_sizes: (B,2) int32 (ow, oh)."""
        # channels-last memory (NHWC, as the JAX graph runs) is the layout
        # cuDNN's tensor-core convs take without transposes; the logits come
        # out NHWC-contiguous and K1 reads the NHWC view in place
        x = x.contiguous(memory_format=torch.channels_last)
        logits = unet_apply_folded(self.folded, x).permute(0, 2, 3, 1)
        return self._post(logits, orig_sizes, return_masks)

    def _forward_int8(self, u8, orig_sizes, return_masks):
        """u8: (B,S,S,3) uint8 NHWC on the device; the int8 routes."""
        q, pq = self.qparams, self.pallas_params
        if not return_masks and (self.int8_head == "pallas" or pq is not None):
            if pq is not None:
                maxima = unet_apply_quantized_pallas_rowcol_max(q, pq, u8)
            else:
                maxima = unet_apply_quantized_rowcol_max(q, u8)
            return self._post_maxima(*maxima, orig_sizes)
        if not return_masks and self.wpack_mode is not None:
            if self.nhwc_params is not None:
                maxima = unet_apply_quantized_nhwc_rowcol_max(q, u8, self.nhwc_params)
            else:
                maxima = unet_apply_quantized_wpack_rowcol_max(q, u8, self.wpack_mode)
            return self._post_maxima(*maxima, orig_sizes)
        bf16 = self.int8_head == "xla-bf16" and not return_masks
        dtype = torch.bfloat16 if bf16 else torch.float32
        return self._post(self._int8_logits(u8, dtype), orig_sizes, return_masks)

    def _int8_logits(self, u8, dtype=torch.float32):
        """The int8 logits: the W-phase trunk's when it serves, else the
        concat trunk's."""
        if self.wpack_mode is not None:
            return unet_apply_quantized_wpack(self.qparams, u8, dtype, self.wpack_mode,
                                              head=self.head_params)
        return unet_apply_quantized(self.qparams, u8, logits_dtype=dtype,
                                    head=self.head_params)

    def _post_maxima(self, row_max, col_max, orig_sizes):
        """Bias-free row/col logit maxima → boxes, scaled and padded."""
        gboxes, valid = bbox_from_rowcol_max(row_max, col_max, self._thr_eff)
        boxes, ok = scale_and_pad_boxes(gboxes, valid, orig_sizes,
                                        self.cfg.img_size, self.cfg.pad_frac)
        return None, boxes, ok

    def _post(self, logits, orig_sizes, return_masks):
        """(B,S,S,3) logits → K1 boxes, scaled and padded, and the masks."""
        gboxes, valid = bbox_postprocess(logits, self._logit_thr)
        boxes, ok = scale_and_pad_boxes(gboxes, valid, orig_sizes,
                                        self.cfg.img_size, self.cfg.pad_frac)
        mask = None
        if return_masks:
            mask = torch.sigmoid(logits.to(torch.float32)) > self._thr
        return mask, boxes, ok

    def _to_device(self, a, dtype):
        if isinstance(a, np.ndarray) and not a.flags.writeable:
            a = a.copy()  # torch.as_tensor shares memory and wants it writable
        return torch.as_tensor(a).to(self.device, dtype, non_blocking=True)

    def _run(self, imgs_u8, orig_sizes, return_masks=True):
        """imgs_u8: (B,S,S,3) uint8, or (B,S,S) luminance replicated to three
        channels on the device (3× fewer host→device bytes)."""
        with torch.inference_mode():
            u8 = self._to_device(imgs_u8, torch.uint8)
            if u8.dim() == 3:
                u8 = u8[..., None].expand(-1, -1, -1, 3)
            sizes = self._to_device(orig_sizes, torch.int32)
            if self.qparams is not None:
                return self._forward_int8(u8, sizes, return_masks)
            x = normalize_uint8(u8.permute(0, 3, 1, 2), self.dtype)
            return self._forward(x, sizes, return_masks)

    def _run_from_raw(self, raw_u8, orig_sizes):
        """Device resize: raw_u8 (B,H,W,3) uint8 at any one H, W. Returns the
        masks always, as JAX's ``_run_from_raw`` does."""
        size = self.cfg.img_size
        with torch.inference_mode():
            raw = self._to_device(raw_u8, torch.uint8).permute(0, 3, 1, 2)
            x = resize_bilinear(raw, size, size)
            sizes = self._to_device(orig_sizes, torch.int32)
            if self.qparams is not None:
                u8 = torch.clamp(torch.round(x), 0, 255).to(torch.uint8)
                return self._post(self._int8_logits(u8.permute(0, 2, 3, 1)), sizes, True)
            return self._forward((x / 255.0).to(self.dtype), sizes, True)

    # -- batch API (throughput path) ---------------------------------------

    def segment_batch(self, imgs_u8, orig_sizes=None, *, pre_resized=True,
                      return_masks=True):
        """Batched device path.

        ``imgs_u8``: uint8 (B, H, W, 3), numpy or torch; if ``pre_resized``
        H=W=img_size, else any H, W, resized on the device. ``orig_sizes``:
        (B, 2) int32 (ow, oh); defaults to the input size. Returns (mask
        (B,S,S,3) bool or None, boxes (B,3,4) int32, ok (B,3) bool) on the
        device. ``return_masks=False`` is the throughput path; the device
        resize ignores it and returns the masks, as JAX's does.
        """
        if orig_sizes is None:
            b, h, w = imgs_u8.shape[:3]
            orig_sizes = np.tile(np.asarray([[w, h]], np.int32), (b, 1))
        if not pre_resized:
            return self._run_from_raw(imgs_u8, orig_sizes)
        return self._run(imgs_u8, orig_sizes, return_masks)

    def _upload(self, arrs, sizes):
        """Host uint8 images and int32 (ow, oh) sizes → device tensors. On a
        card they are copied from pinned memory on a side stream, so that the
        copy runs under the compute already queued, and the compute stream
        waits for it."""
        x = torch.from_numpy(np.ascontiguousarray(arrs))
        s = torch.from_numpy(np.ascontiguousarray(sizes, np.int32))
        if self.device.type != "cuda":
            return x.to(self.device), s.to(self.device)
        x, s = x.pin_memory(), s.pin_memory()
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            dx = x.to(self.device, non_blocking=True)
            ds = s.to(self.device, non_blocking=True)
        compute.wait_stream(self._copy_stream)
        dx.record_stream(compute)  # the allocator keeps them until it is done
        ds.record_stream(compute)
        return dx, ds

    def _segment_host(self, prep, sizes, *, return_masks, h2d_chunks):
        """The host-resize batch route: ``prep(a, b)`` gives items a..b as
        uint8 (b − a, S, S[, 3]); ``sizes`` (n, 2) int32 (ow, oh). With
        ``h2d_chunks > 1``, at least two items a chunk and box-only, the
        batch is split as JAX's ``segment_pil_batch`` splits it
        (``np.linspace``) and every chunk is dispatched before any is
        fetched, so chunk k+1's prep and upload run under chunk k's device
        work. → (mask or None, boxes, ok) as numpy, one call's results."""
        from twinvoice_tpu_torch.utils.tracing import trace_span

        n = len(sizes)
        if h2d_chunks > 1 and n >= 2 * h2d_chunks and not return_masks:
            bounds = np.linspace(0, n, h2d_chunks + 1).astype(int)
        else:
            bounds = np.asarray([0, n])
        pending = []
        for a, b in zip(bounds[:-1], bounds[1:]):
            with trace_span("segment.prep"):
                arrs = prep(a, b)
            with trace_span("segment.h2d"):
                dev, dev_sizes = self._upload(arrs, sizes[a:b])
            with trace_span("segment.dispatch"):
                pending.append(self._run(dev, dev_sizes, return_masks=return_masks))
        with trace_span("segment.fetch"):
            mask = (np.concatenate([m.cpu().numpy() for m, _, _ in pending])
                    if return_masks else None)
            boxes = np.concatenate([bx.cpu().numpy() for _, bx, _ in pending])
            ok = np.concatenate([o.cpu().numpy() for _, _, o in pending])
        return mask, boxes, ok

    @staticmethod
    def _field_masks(mask, bi):
        return None if mask is None else {f: mask[bi, :, :, i] for i, f in enumerate(FIELDS)}

    def segment_pil_batch(self, pil_images, *, return_masks=True,
                          gray_h2d=False, h2d_chunks=1):
        """Batched PIL path: one device call segments all images (one a
        chunk with ``h2d_chunks``); crops are sliced per image on the host.
        → list of (masks, crops) pairs with :meth:`segment_pil`'s contract.
        ``return_masks=False`` fetches only the boxes. ``gray_h2d=True``
        uploads luminance and replicates it to three channels on the device
        (3× fewer host→device bytes). ``h2d_chunks`` (box-only) pipelines
        the host resize and upload under the device work
        (:meth:`_segment_host`); the results are one call's.
        """
        size = self.cfg.img_size
        convert = "L" if gray_h2d else "RGB"

        try:  # host resize with OpenCV when present, else Pillow
            import cv2

            def prep1(im):
                arr = np.asarray(im.convert("RGB"))
                if gray_h2d:
                    arr = cv2.cvtColor(arr, cv2.COLOR_RGB2GRAY)
                return cv2.resize(arr, (size, size), interpolation=cv2.INTER_AREA)
        except ImportError:

            def prep1(im):
                return np.asarray(im.convert(convert).resize((size, size)), np.uint8)

        sizes = np.asarray([im.size for im in pil_images], np.int32)
        mask, boxes, ok = self._segment_host(
            lambda a, b: np.stack([prep1(im) for im in pil_images[a:b]]), sizes,
            return_masks=return_masks, h2d_chunks=h2d_chunks)
        return [(self._field_masks(mask, bi),
                 _pil_crops(im, boxes[bi], ok[bi], self.cfg.black_crop_mean))
                for bi, im in enumerate(pil_images)]

    def segment_array_batch(self, pages, *, return_masks=True, gray_h2d=False,
                            h2d_chunks=1):
        """:meth:`segment_pil_batch` on uint8 (H, W, 3) RGB pages at their
        own sizes, without Pillow or OpenCV: the host prep is the JAX
        package's OpenCV branch in numpy (``rgb_to_gray`` when ``gray_h2d``,
        then ``resize_area_u8`` to S²), and the crops are
        :func:`crop_fields` views of the pages."""
        size = self.cfg.img_size

        def prep1(page):
            return resize_area_u8(rgb_to_gray(page) if gray_h2d else page, size, size)

        sizes = np.asarray([(p.shape[1], p.shape[0]) for p in pages], np.int32)
        mask, boxes, ok = self._segment_host(
            lambda a, b: np.stack([prep1(p) for p in pages[a:b]]), sizes,
            return_masks=return_masks, h2d_chunks=h2d_chunks)
        return [(self._field_masks(mask, bi),
                 crop_fields(page, boxes[bi], ok[bi], self.cfg.black_crop_mean))
                for bi, page in enumerate(pages)]

    # -- single-image API (reference-parity surface) -----------------------

    def _segment_one(self, small, ow, oh):
        """One host-resized (S, S, 3) uint8 image of an (ow, oh) original →
        (masks dict, boxes (3, 4), ok (3,)) on the host."""
        mask, boxes, ok = self._run(small[None], np.asarray([[ow, oh]], np.int32))
        mask = mask[0].cpu().numpy()
        masks = {f: mask[:, :, i] for i, f in enumerate(FIELDS)}
        return masks, boxes[0].cpu().numpy(), ok[0].cpu().numpy()

    def segment_pil(self, pil_img):
        """→ ``(masks: dict[field, bool (S,S)], crops: dict[field, PIL|None])``.

        The resize runs on the host with Pillow, as the JAX ``segment_pil``
        does; the model and the boxes run on the device.
        """
        size = self.cfg.img_size
        small = np.asarray(pil_img.convert("RGB").resize((size, size)), np.uint8)
        masks, boxes, ok = self._segment_one(small, *pil_img.size)
        return masks, _pil_crops(pil_img, boxes, ok, self.cfg.black_crop_mean)

    def segment_array(self, page):
        """:meth:`segment_pil` on a uint8 (H, W, 3) RGB page, without
        Pillow: the resize is Pillow's default bicubic in numpy
        (``resize_pil_bicubic``), and the crops are :func:`crop_fields`
        views of the page."""
        size = self.cfg.img_size
        small = resize_pil_bicubic(page, size, size)
        masks, boxes, ok = self._segment_one(small, page.shape[1], page.shape[0])
        return masks, crop_fields(page, boxes, ok, self.cfg.black_crop_mean)
