"""NN ops on tensors, NCHW (``twinvoice_tpu.ops``): conv, pool, BatchNorm
and its fold, device resizes; and the hand-written CUDA kernels
(``bbox_postprocess``, ``head``, ``qconv``, ``qupsample``, ``nhwc_conv``)
with their plain PyTorch versions. ``host_image`` holds the host steps
OpenCV and Pillow do in the JAX package, in numpy."""

from twinvoice_tpu_torch.ops.conv import (
    conv2d,
    conv1x1,
    conv3x3,
    conv_transpose2x2,
    max_pool2,
    init_conv,
    init_conv_transpose,
)
from twinvoice_tpu_torch.ops.norm import (
    init_batchnorm,
    batchnorm_apply,
    fold_batchnorm_into_conv,
)
from twinvoice_tpu_torch.ops.image import resize_bilinear, resize_nearest, normalize_uint8
