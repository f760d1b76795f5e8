"""Segmentation datasets (``twinvoice_tpu.data``): ``dataset``, the labelme
converter (``labelme``; OpenCV reads and writes its image files) and the pure
helpers of ``synthetic``. The renderer (``synthetic.render_invoice``) and the
augmentations (``augment``) draw with Pillow and OpenCV and stay host-side
in the JAX package."""

from twinvoice_tpu_torch.data.dataset import ArrayDataset, load_invoice_dataset, synthetic_dataset
from twinvoice_tpu_torch.data.labelme import build_dataset_from_labelme, rasterize_labelme
