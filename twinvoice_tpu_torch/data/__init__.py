"""Segmentation datasets (``twinvoice_tpu.data``): ``dataset``, the labelme
converter (``labelme``; OpenCV reads and writes its image files), the
perturbation engine (``augment``: numpy, no OpenCV) and the pure helpers of
``synthetic``. The renderer (``synthetic.render_invoice``) draws with Pillow
and TrueType fonts and stays host-side in the JAX package."""

from twinvoice_tpu_torch.data.dataset import ArrayDataset, load_invoice_dataset, synthetic_dataset
from twinvoice_tpu_torch.data.labelme import build_dataset_from_labelme, rasterize_labelme
