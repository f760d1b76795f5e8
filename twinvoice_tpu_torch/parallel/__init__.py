"""Spatial and pipeline parallelism (``twinvoice_tpu.parallel``)."""

from twinvoice_tpu_torch.parallel.spatial import (
    conv3x3_spatial,
    halo_exchange_h,
    spatial_shard_apply,
)
