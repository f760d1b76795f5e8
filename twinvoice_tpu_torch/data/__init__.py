"""Segmentation datasets (``twinvoice_tpu.data``): ``dataset``, the labelme
converter (``labelme``), the perturbation engine (``augment``: numpy, no
OpenCV) and the synthetic invoices (``synthetic``: ``render_invoice``, the
training and held-out font registries, the QR payloads), without Pillow,
FreeType or OpenCV."""

from twinvoice_tpu_torch.data.dataset import ArrayDataset, load_invoice_dataset, synthetic_dataset
from twinvoice_tpu_torch.data.labelme import build_dataset_from_labelme, rasterize_labelme
