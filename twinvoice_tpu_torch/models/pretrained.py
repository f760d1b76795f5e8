"""The bundled segmenters, served by the port.

The weights are the JAX package's npz files, read where they lie
(``twinvoice_tpu/models/weights/``) as data files with numpy; nothing of the
JAX package is imported and nothing is copied or converted into this tree.
"""

from __future__ import annotations

import os

import torch

from twinvoice_tpu_torch import resolve_device
from twinvoice_tpu_torch.config import InferConfig, UNetConfig

WEIGHTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "twinvoice_tpu", "models", "weights",
)

# variant → (file, architecture, training grid)
VARIANTS = {
    "w16": ("segmenter_synth_w16.npz", UNetConfig(base_width=16), 512),
    "w16_g384": ("segmenter_synth_w16_g384.npz", UNetConfig(base_width=16), 384),
    "w64": ("segmenter_synth_w64.npz", UNetConfig(base_width=64), 512),
}


def variant_path(variant: str) -> str:
    return os.path.join(WEIGHTS_DIR, VARIANTS[variant][0])


def load_pretrained_segmenter(dtype=torch.bfloat16, infer_cfg: InferConfig = None,
                              variant: str = "w16", *, device=None,
                              **segmenter_kw):
    """→ a ready :class:`~twinvoice_tpu_torch.infer.pipeline.Segmenter` on
    bundled trained weights. The positional order is the JAX package's
    (``dtype, infer_cfg, variant``), so a positional call means the same in
    both. ``infer_cfg`` defaults to the variant's training grid;
    ``device=None`` means ``"cuda"``. Extra keywords (``int8_calib``,
    ``int8_head``, ...) pass through to the ``Segmenter``."""
    from twinvoice_tpu_torch.infer.pipeline import Segmenter
    from twinvoice_tpu_torch.weights import load_npz

    device = resolve_device(device)
    _, mcfg, grid = VARIANTS[variant]
    if infer_cfg is None:
        infer_cfg = InferConfig(img_size=grid)
    params, state = load_npz(variant_path(variant))
    return Segmenter(params, state, mcfg, infer_cfg, dtype=dtype, device=device,
                     **segmenter_kw)


def available(variant: str = "w16") -> bool:
    """Whether the bundled weights of ``variant`` are present."""
    return os.path.exists(variant_path(variant))
