"""twinvoice_tpu_torch — the PyTorch/CUDA port of ``twinvoice_tpu``.

It grows slice by slice beside the JAX package, which stays the reference
every part is held against. It imports torch, numpy and the standard library,
and never JAX, the JAX package, Pillow or OpenCV at module level: what it
needs from the JAX package it keeps as its own copy.

Layout: module names mirror ``twinvoice_tpu``. Inside, tensors are NCHW;
public functions keep the JAX package's layout (NHWC uint8 in; boxes
``(B,3,4)`` int32 ``[x1,y1,x2,y2]`` and valid ``(B,3)`` bool out) so the two
packages compare like with like.

- ``ops``      conv / pool / resize / BN-fold on tensors, plus the hand-written
               CUDA kernels (``csrc/``, built by ``_build``) with their plain
               PyTorch versions
- ``models``   the BN-folded U-Net forward and the bundled segmenters
- ``infer``    box post-processing and the ``Segmenter`` serving path
- ``weights``  bundled npz weights read with numpy; JAX pytree → torch layout
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

FIELDS = ("invoice_no", "date", "total_amount")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Raises when a CUDA device is asked for (or implied) and none is present;
    running on the CPU has to be asked for with ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
