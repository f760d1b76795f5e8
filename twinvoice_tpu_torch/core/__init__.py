"""The rank grid, the collectives on it and the precision policy
(``twinvoice_tpu.core``)."""

from twinvoice_tpu_torch.core.mesh import make_mesh, batch_sharding, param_shardings
from twinvoice_tpu_torch.core.precision import Policy
