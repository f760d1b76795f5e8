"""The reference ``.pth`` schema ↔ the port's U-Net trees
(``twinvoice_tpu.port``)."""

from twinvoice_tpu_torch.port.torch_port import (
    port_state_dict,
    load_pth,
    export_state_dict,
)
