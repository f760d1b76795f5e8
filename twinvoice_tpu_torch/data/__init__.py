"""Segmentation datasets (``twinvoice_tpu.data``): ``dataset``, the labelme
converter (``labelme``), the perturbation engine (``augment``: numpy, no
OpenCV) and ``synthetic``'s helpers and training-font registry
(``train_fonts``). The invoice renderer (``synthetic.render_invoice``) is not
ported yet (``ROADMAP.md``, queue 1)."""

from twinvoice_tpu_torch.data.dataset import ArrayDataset, load_invoice_dataset, synthetic_dataset
from twinvoice_tpu_torch.data.labelme import build_dataset_from_labelme, rasterize_labelme
